"""Device ms a traced step spends in NCCL's kernels (the gradient and metric
all-reduces of ``engine/train_step.exchange``), the worst rank."""

KERNELS = ("nccl",)


def read(run):
    per_rank = []
    for tl in run.timelines:
        sec = tl.op_seconds(lambda name: any(k in name.lower() for k in KERNELS))
        if sec > 0 and tl.calls:
            per_rank.append(sec * 1e3 / tl.calls)
    return max(per_rank) if per_rank else None
