"""The Sinkhorn kernel's SFU bound a pair (``counts/bounds.sinkhorn_pair_bound_ms``)
over the device time a traced request spends in it (``csrc/sinkhorn.cu``)."""

from benchmark.harness.readers import roofline

KERNELS = ("sinkhorn",)


def read(run):
    return roofline(run, "sinkhorn", KERNELS)
