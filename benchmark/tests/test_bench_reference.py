"""The plain reference agrees with the port's eager CPU path at the tiny
config: served outputs equal, and the first training steps' losses, gradients
and changes within float32 rounding of Adam's arithmetic."""

import numpy as np
import pytest
import torch

from benchmark.harness import judge, scans
from benchmark.harness.weights import draw_weights, load_weights
from benchmark.reference import api
from benchmark.tests.tiny import tiny_config

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    from rdmnet_tpu_torch.config import Config, config_from_dict
    from rdmnet_tpu_torch.models import RDMNet

    values = tiny_config()["config"]
    port_cfg = config_from_dict(Config, values)
    model = RDMNet(port_cfg, device="cpu")
    weights = draw_weights({n: tuple(p.shape) for n, p in model.named_parameters()}, 21, CPU)
    load_weights(model, weights)
    pairs = scans.pair_pool(8, 1, 3, 16, 200, 10.0, False, CPU)
    return values, port_cfg, model, weights, pairs


def test_served_outputs_equal_the_port(setup):
    from rdmnet_tpu_torch.models import pipeline

    values, port_cfg, model, weights, pairs = setup
    rmodel = api.make_model(api.make_config(values), weights, CPU)
    cap = port_cfg.pyramid.caps[0]
    for ref, src, _ in pairs:
        (rp, rc), (sp, sc) = api.pad(ref, cap), api.pad(src, cap)
        out = pipeline(model, rp, np.int32(rc), sp, np.int32(sc), device="cpu")
        got = api.serve_pair(rmodel, ref, src)
        for k in api.SERVE_OUTPUTS:
            np.testing.assert_array_equal(out[k].numpy(), got[k])


def test_train_steps_follow_the_port(setup):
    from rdmnet_tpu_torch import engine
    from rdmnet_tpu_torch.data.loader import pad_points_np
    from rdmnet_tpu_torch.engine.train_step import batch_inputs, build_batch
    from rdmnet_tpu_torch.models import RDMNet

    values, port_cfg, _, weights, pairs = setup
    model = RDMNet(port_cfg, device="cpu")
    load_weights(model, weights)
    state = engine.create_train_state(port_cfg, model, steps_per_epoch=10)
    step = engine.make_train_step(port_cfg, "cpu")
    cap = port_cfg.pyramid.caps[0]
    fed = []
    for ref, src, tf in pairs + pairs[:1]:
        (rp, rc), (sp, sc) = pad_points_np(ref, cap), pad_points_np(src, cap)
        fed.append({"ref_points": rp[None], "ref_counts": np.array([rc]), "src_points": sp[None],
                    "src_counts": np.array([sc]), "transform": tf[None],
                    "ref_dropped": np.zeros(1, np.int32), "src_dropped": np.zeros(1, np.int32)})
    gen = torch.Generator().manual_seed(4)
    losses, grad1 = [], None
    for i, b in enumerate(fed):
        inputs = {k: torch.as_tensor(v) for k, v in batch_inputs(b).items()}
        _, metrics = step(state, build_batch(inputs, port_cfg.pyramid), gen)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad1 = {n: state.optimizer.state[p]["exp_avg"] / 0.1
                     for n, p in zip(state.param_names, state.params)}
    rmodel = api.make_model(api.make_config(values), weights, CPU)
    out = api.train_steps(rmodel, fed, torch.Generator().manual_seed(4), steps_per_epoch=10)
    np.testing.assert_allclose(losses, out["losses"], rtol=1e-4)
    for n in state.param_names:
        torch.testing.assert_close(grad1[n], out["grads"][n], rtol=1e-4, atol=1e-6)
    # Adam's first steps move an entry by ~lr whatever its gradient's size, so
    # entries of gradients near eps part on rounding: compare leaves' norms
    change = {n: p.detach() - weights[n] for n, p in zip(state.param_names, state.params)}
    gaps = judge.leaf_gaps(change, out["change"], keep=judge.moved_leaves(out["grads"]))
    assert max(gaps.values()) < 1e-3
