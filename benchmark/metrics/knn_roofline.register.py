"""The radius-kNN kernel's bound a pair (``counts/bounds.knn_pair_bound_ms``,
the 12 searches of the traced pairs' graph builds) over the device time a
traced request spends in it (``csrc/radius_knn.cu``)."""

from benchmark.harness.readers import roofline

KERNELS = ("radius_knn",)


def read(run):
    return roofline(run, "radius_knn", KERNELS)
