"""NMS rounds a served request, from the program's counter."""

from benchmark.harness.stages import per_request

read = per_request(("pipeline.nms_rounds",))
