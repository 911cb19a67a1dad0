// Stage marks for Hopper (sm_90a): one empty kernel a stage boundary.
//
// Replaces no TPU kernel. The port's hot paths are CUDA graphs (the served
// pipeline, the train step, the data-parallel step's two halves), and a
// host range recorded at capture does not come back at a replay. A kernel
// does: rdmnet_tpu_torch/trace.py launches rdmnet_mark_<name> at each stage
// boundary while a graph is captured (and eagerly on a card while a
// torch.profiler profile records), so every replay carries its stage
// boundaries into the device trace, named, on the profiler's clock. A
// graph captured from one stream runs its nodes in capture order, so the
// marks come out in the order the code placed them.
//
// What bounds it: launch latency alone. Each kernel is one thread that does
// nothing; a replay runs about eight of them a served pair.
//
// Design: one extern "C" kernel a name, so the symbol the profiler shows is
// the name itself; the names are the model's STAGES, the train step's
// TRAIN_STAGES, "begin" (a captured body's entry), "gradients" (the end of
// the data-parallel gradient half) and "update" (the start of its update
// half). rdmnet_mark_launch takes an index into the table below;
// rdmnet_mark_name gives each index's name, so the Python side builds its
// table from the library. rdmnet_mark_load loads every kernel without a
// launch: a module must not load lazily inside a stream capture.

#include <cuda_runtime.h>

#define RDMNET_MARKS(X) \
  X(begin)              \
  X(build)              \
  X(encoder_t1)         \
  X(decoder)            \
  X(vote_t2)            \
  X(matching)           \
  X(ot)                 \
  X(lgr)                \
  X(forward)            \
  X(losses)             \
  X(backward)           \
  X(optimizer)          \
  X(gradients)          \
  X(update)

#define RDMNET_MARK_KERNEL(name) \
  extern "C" __global__ void rdmnet_mark_##name() {}
RDMNET_MARKS(RDMNET_MARK_KERNEL)

struct MarkEntry {
  const char* name;
  void (*kernel)();
};

#define RDMNET_MARK_ENTRY(name) {#name, rdmnet_mark_##name},
static const MarkEntry kMarks[] = {RDMNET_MARKS(RDMNET_MARK_ENTRY)};
static const int kMarkCount = (int)(sizeof(kMarks) / sizeof(kMarks[0]));

extern "C" int rdmnet_mark_count() { return kMarkCount; }

extern "C" const char* rdmnet_mark_name(int i) {
  return (i >= 0 && i < kMarkCount) ? kMarks[i].name : nullptr;
}

extern "C" int rdmnet_mark_load() {
  for (int i = 0; i < kMarkCount; ++i) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kMarks[i].kernel);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int rdmnet_mark_launch(int i, void* stream) {
  if (i < 0 || i >= kMarkCount) return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel((const void*)kMarks[i].kernel, dim3(1), dim3(1), nullptr, 0,
                               (cudaStream_t)stream);
}
