"""Points a served request loses: rows truncated to the bucket on the host
and points or voxels the pyramid's capacities cut, from the program's
counters."""

from benchmark.harness.stages import per_request

read = per_request(("pipeline.dropped", "serve.truncated_rows"))
