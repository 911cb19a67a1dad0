"""Training: the port's captured train step (``engine.capture_train_step``,
batch ``batch_size``) fed by its ``PairLoader`` (shuffle, drop_last,
``prefetch``) over ``RegistrationPairDataset`` with the train config's
point limit and augmentation, on a dataset root in ``dataset``'s layout
written at set-up from seeded procedural sequences. This is the step the
Trainer runs (``cli/trainval.py`` builds the same loader and state).

The program's first ``check_steps`` calls on the loader's batches take its
eager warm-ups and its capture. Then the train state (parameters, buffers,
Adam's moments and steps, the counters) and the target generator go back
in place to where the seed set them, and the same batches run again
through the same call: on a card these are replays of the captured graph.
Their losses, the first gradient as Adam holds it and the parameters after
each step are kept for the reference, which takes the same weights, batches
and target draws and judges each step's loss from the program's parameters
before it. ``warmup_steps`` more replays, then the window.

Traffic parameters: ``bucket_scale``, ``dataset``, ``sequences`` x
``frames``, ``n_rings``, ``n_azimuths``, ``step``, ``enrich``,
``batch_size``, ``prefetch``, ``warmup_steps``, ``trace_steps``,
``check_steps``."""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import tempfile
import time
from typing import Dict, Iterator

import numpy as np

from benchmark.harness import judge, scans, seeds
from benchmark.harness.record import note
from benchmark.harness.trace import span, trace_calls
from benchmark.harness.weights import draw_weights, load_weights

BETA1 = 0.9  # torch.optim.Adam's default, which the port's optimizer keeps
BATCH_KEYS = ("ref_points", "ref_counts", "src_points", "src_counts", "transform",
              "ref_dropped", "src_dropped")


def port_config(cell):
    from rdmnet_tpu_torch.config import Config, config_from_dict

    cfg = config_from_dict(Config, cell.config["config"])
    scale = cell.traffic["bucket_scale"]
    if scale != 1.0:
        cfg = dataclasses.replace(cfg, pyramid=cfg.pyramid.scaled(scale))
    return cfg


def write_root(root: str, cell, seed: int, device) -> None:
    """The dataset root: ``sequences`` seeded sequences as the first train
    sequences of the layout, consecutive frames paired under their poses;
    the layout's other sequences get empty pair files."""
    from rdmnet_tpu_torch.data.datasets import SCHEMAS

    t = cell.traffic
    schema = SCHEMAS[t["dataset"]]
    for n, seq in enumerate(schema.train_seqs[:t["sequences"]]):
        frames, poses = scans.sequence(seeds.stream(seed, "traffic") * 1000 + n, t["frames"],
                                       t["n_rings"], t["n_azimuths"], t["step"], t["enrich"],
                                       device)
        for i, scan in enumerate(frames):
            path = os.path.join(root, schema.cloud_path.format(seq=seq, frame=i))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, scan)
        lines = []
        for i in range(len(frames) - 1):
            tf = np.linalg.inv(poses[i]) @ poses[i + 1]
            lines.append(f"{i + 1} {i} " + " ".join(f"{v:.9f}" for v in tf[:3].reshape(-1)))
        gt = os.path.join(root, schema.gt_file.format(seq=seq))
        os.makedirs(os.path.dirname(gt), exist_ok=True)
        with open(gt, "w") as f:
            f.write("\n".join(lines))
    for seq in schema.train_seqs + schema.val_seqs + schema.test_seqs:
        gt = os.path.join(root, schema.gt_file.format(seq=seq))
        if not os.path.exists(gt):
            os.makedirs(os.path.dirname(gt), exist_ok=True)
            open(gt, "a").close()


def endless(loader) -> Iterator[dict]:
    while True:
        yield from loader


def first_gradient(state) -> Dict[str, "object"]:
    """The gradient Adam took in its first step, from its first moment
    (zero for a leaf the optimizer never stepped), on the host."""
    import torch

    out = {}
    for n, p in zip(state.param_names, state.params):
        m = state.optimizer.state.get(p, {}).get("exp_avg")
        out[n] = (torch.zeros_like(p) if m is None else m / (1 - BETA1)).detach().cpu()
    return out


def make_loader(cell, cfg, root: str, seed: int, rank: int = 0, world: int = 1,
                prefetch: int = None):
    """The train traffic's ``PairLoader`` over ``RegistrationPairDataset`` at
    ``root``, as ``cli/trainval.py`` builds it: the train config's point
    limit and augmentation, one shuffled order for all ranks, rank
    ``rank``'s shard of ``world``."""
    from rdmnet_tpu_torch.data.datasets import RegistrationPairDataset
    from rdmnet_tpu_torch.data.loader import PairLoader

    t, tc = cell.traffic, cfg.train
    dataset = RegistrationPairDataset(
        t["dataset"], root=root, subset="train", point_limit=tc.point_limit,
        use_augmentation=tc.use_augmentation, augmentation_noise=tc.augmentation_noise,
        augmentation_min_scale=tc.augmentation_min_scale,
        augmentation_max_scale=tc.augmentation_max_scale,
        augmentation_shift=tc.augmentation_shift, augmentation_rotation=tc.augmentation_rotation,
        seed=(seeds.stream(seed, "loader") + rank) % (1 << 32))
    shard = {"num_hosts": world, "host_id": rank} if world > 1 else {}
    return PairLoader(dataset, cap=cfg.pyramid.caps[0], batch_size=t["batch_size"],
                      shuffle=True, drop_last=True, seed=seeds.stream(seed, "order") % (1 << 32),
                      prefetch=t["prefetch"] if prefetch is None else prefetch, **shard)


def snapshot(state) -> list:
    """Copies of the parameters and buffers, on their device."""
    return [t.detach().clone() for t in list(state.params) + list(state.model.buffers())]


def reset(state, start: list, generator, seed: int) -> None:
    """The train state back to ``start`` (``snapshot``'s) and a fresh
    optimizer, and the generator back to its seed, each in place: a
    captured program reads these tensors where they are."""
    import torch

    with torch.no_grad():
        for t, s in zip(list(state.params) + list(state.model.buffers()), start):
            t.copy_(s)
        for st in state.optimizer.state.values():  # Adam's moments and step counts
            for v in st.values():
                if torch.is_tensor(v):
                    v.zero_()
        for c in state.counters.values():
            c.zero_()
        if state.accumulator is not None:
            state._flat_accumulator.zero_()
    generator.manual_seed(seed)


def checked_steps(program, state, fed, start, generator, seed: int):
    """``reset``, then ``fed``'s batches through ``program``: (the losses,
    the gradient Adam took in step 1, the parameters after each step), on
    the host."""
    reset(state, start, generator, seed)
    losses, after = [], []
    for i, batch in enumerate(fed):
        losses.append(float(program(batch)["loss"]))
        if i == 0:
            grads = first_gradient(state)
        after.append({n: p.detach().to("cpu", copy=True)
                      for n, p in zip(state.param_names, state.params)})
    return losses, grads, after


def make_program(state, cfg, batch_size, generator, device):
    """The captured step on a card; on the CPU (the tests) the same step eagerly."""
    from rdmnet_tpu_torch import engine

    if device.type == "cuda":
        return engine.capture_train_step(state, cfg, batch_size, generator, device)
    import torch

    from rdmnet_tpu_torch.engine.train_step import batch_inputs, build_batch

    step = engine.make_train_step(cfg, device)

    def program(np_batch):
        inputs = {k: torch.as_tensor(v) for k, v in batch_inputs(np_batch).items()}
        return step(state, build_batch(inputs, cfg.pyramid), generator)[1]

    return program


def run(cell, rec, device, t_start: float) -> Dict[str, object]:
    import torch

    from rdmnet_tpu_torch import engine
    from rdmnet_tpu_torch.models import RDMNet

    t = cell.traffic
    cfg = port_config(cell)
    tmp = tempfile.TemporaryDirectory(prefix="bench-root-")
    write_root(tmp.name, cell, rec.seed, device)
    note("dataset root written", t_start)
    loader = make_loader(cell, cfg, tmp.name, rec.seed)
    model = RDMNet(cfg, device=device)
    note("port model built", t_start)
    load_weights(model, draw_weights({n: tuple(p.shape) for n, p in model.named_parameters()},
                                     seeds.stream(rec.seed, "weights"), device))
    state = engine.create_train_state(cfg, model, steps_per_epoch=len(loader))
    generator = torch.Generator(device).manual_seed(target_seed(rec.seed))
    program = make_program(state, cfg, t["batch_size"], generator, device)
    start = snapshot(state)
    note("weights drawn, train state and program made", t_start)
    batches = endless(loader)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    # the eager warm-ups and the capture, then the checked steps: the same
    # batches from the seed's state, through the program's own call
    fed = [{k: np.array(b[k]) for k in BATCH_KEYS}
           for b in (next(batches) for _ in range(t["check_steps"]))]
    for batch in fed:
        program(batch)
    losses, grads, after = checked_steps(program, state, fed, start, generator,
                                         target_seed(rec.seed))
    del start
    note("warm-ups and capture, then the checked steps", t_start)
    for _ in range(t["warmup_steps"]):
        program(next(batches))
    sync()
    count0 = state.count
    rec.setup_s = time.perf_counter() - t_start

    steps, waits = 0, []
    t0 = time.perf_counter()
    while True:
        tw = time.perf_counter()
        batch = next(batches)
        waits.append(time.perf_counter() - tw)
        program(batch)
        steps += 1
        if time.perf_counter() - t0 >= rec.seconds:
            break
    sync()
    rec.window_s = time.perf_counter() - t0
    rec.attempted = steps
    rec.failed = steps - (state.count - count0)  # steps the non-finite guard skipped
    rec.items = steps * t["batch_size"]
    rec.loader_wait_s = waits
    rec.e2e["train_pairs_per_s"] = rec.items / rec.window_s
    rec.e2e["setup_s"] = rec.setup_s

    if rec.trace:
        def call(i):
            with span("loader.next"):
                batch = next(batches)
            with span("program"):
                program(batch)

        rec.timelines = [trace_calls(call, t["trace_steps"], sync)]
    if device.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    steps_per_epoch = len(loader)
    batches.close()
    del program, state, model, batches, loader
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tmp.cleanup()
    return {"fed": fed, "losses": losses, "grads": grads, "after": after,
            "steps_per_epoch": steps_per_epoch}


def reference_steps(cell, seed: int, device, fed, steps_per_epoch: int, tf32: bool,
                    count_flops: bool = False, world: int = 1, states=None):
    """The reference's steps over ``fed`` from the seed's weights and target
    draws (``world`` ranks: pair b of a step is rank b's and draws from rank
    b's generator): (its ``train_steps`` result, the starting weights on the
    host, and with ``count_flops`` the FLOPs of one pair's forward and
    backward, else None). With ``states`` (the parameters after each step
    but the last, by name) the result's ``step_losses`` hold each step's
    loss from the seed's weights, then from those states, with the same
    draws."""
    import torch

    from benchmark.counts.flops import counted
    from benchmark.reference import api
    from benchmark.reference.device import set_precision
    from benchmark.reference.models.rdmnet import RDMNet as RefRDMNet

    set_precision(tf32)
    try:
        cfg = api.make_config(cell.config["config"], cell.traffic["bucket_scale"])
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, dp=world))
        shapes = {n: tuple(p.shape) for n, p in
                  RefRDMNet(cfg, device=torch.device("meta")).named_parameters()}
        weights = draw_weights(shapes, seeds.stream(seed, "weights"), device)
        model = api.make_model(cfg, weights, device)
        start = {k: v.cpu() for k, v in weights.items()}
        del weights
        generators = [torch.Generator(device).manual_seed(target_seed(seed, r))
                      for r in range(world)]
        out = api.train_steps(model, fed, generators if world > 1 else generators[0],
                              steps_per_epoch)
        if states is not None:
            for r, g in enumerate(generators):
                g.manual_seed(target_seed(seed, r))
            out["step_losses"] = api.step_losses(
                model, fed, generators if world > 1 else generators[0],
                [start] + list(states))
        flops = None
        if count_flops:  # one pair's forward and backward, after the checked steps
            _, flops = counted(lambda: api.pair_gradient(model, fed[0], generators[0]))
    finally:
        set_precision(False)
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["grads"] = {k: v.cpu() for k, v in out["grads"].items()}
    return out, start, flops


def target_seed(seed: int, rank: int = 0) -> int:
    """The seed of rank ``rank``'s target generator."""
    return seeds.stream(seed, "targets") + rank


def check(cell, rec, device, state, tf32: bool = False) -> None:
    t_check = time.perf_counter()
    ref, start, flops = reference_steps(cell, rec.seed, device, state["fed"],
                                        state["steps_per_epoch"], tf32, count_flops=rec.trace,
                                        states=state["after"][:-1])
    rec.checks = train_checks(state, ref, start)
    note("reference steps", t_check)
    rec.flops_per_item = flops


def train_checks(program: dict, ref: dict, start: dict) -> Dict[str, float]:
    """The numbers compared: the largest relative gap between a checked
    step's loss and the reference's loss of that step from the program's own
    parameters before it (``ref["step_losses"]``), and, of step 1, where the
    program and the reference start from the same state, the worst leaf's
    gap of the gradient Adam took and of the parameters' change. The losses
    of the reference's own steps and the median and worst leaves' change
    gaps after the checked steps go to standard error: a step after the
    first starts from parameters that fused Adam and the plain one rounded
    apart, and a near-tie the rounding flips moves those numbers on some
    seeds (``PERF.md``). Leaves whose reference gradient is nought to
    rounding are left out of the changes."""
    losses = program["losses"]
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, ref["step_losses"])]
    if not all(np.isfinite(losses)) or len(gaps) != len(losses):
        gaps = [float("inf")]
    moved = judge.moved_leaves(ref["grads"])
    after = program["after"]
    first = judge.leaf_gaps({k: after[0][k] - start[k] for k in start}, ref["change_first"],
                            keep=moved)
    later = judge.leaf_gaps({k: after[-1][k] - start[k] for k in start}, ref["change"],
                            keep=moved)
    worst = max(later, key=later.get)
    print(f"losses: program {losses}, reference from the program's states "
          f"{ref['step_losses']}, reference's own steps {ref['losses']}; change after the "
          f"checked steps: median leaf's gap {float(np.median(list(later.values())))!r}, worst "
          f"{later[worst]!r} ({worst})", file=sys.stderr)
    return {
        "loss_gap": max(gaps),
        "grad_gap": max(judge.leaf_gaps(program["grads"], ref["grads"]).values()),
        "change_gap_first": max(first.values()),
    }


def control(cell, seed: int, device) -> Dict[str, float]:
    """The comparison with the reference in TF32 in the program's place, on
    the batches a run's loader gives first."""
    t = cell.traffic
    cfg = port_config(cell)
    with tempfile.TemporaryDirectory(prefix="bench-root-") as root:
        write_root(root, cell, seed, device)
        loader = make_loader(cell, cfg, root, seed, prefetch=0)
        batches = endless(loader)
        fed = [{k: np.array(b[k]) for k in BATCH_KEYS}
               for b in (next(batches) for _ in range(t["check_steps"]))]
        steps_per_epoch = len(loader)
    tf32, start, _ = reference_steps(cell, seed, device, fed, steps_per_epoch, tf32=True)
    return control_checks(cell, seed, device, fed, steps_per_epoch, tf32, start)


def control_checks(cell, seed: int, device, fed, steps_per_epoch: int, tf32: dict, start: dict,
                   world: int = 1) -> Dict[str, float]:
    """``train_checks`` of the TF32 reference's steps (``tf32``) put in the
    program's place, against the float32 reference."""
    f32, _, _ = reference_steps(cell, seed, device, fed, steps_per_epoch, False, world=world,
                                states=tf32["after"][:-1])
    program = {"losses": tf32["losses"], "grads": tf32["grads"], "after": tf32["after"]}
    return train_checks(program, f32, start)
