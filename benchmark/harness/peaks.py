"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit). fp32 work is held against the TF32 tensor-core rate: the
fastest rate any fp32-accurate implementation can use, so that no share
passes 100% whatever implements an op."""

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
