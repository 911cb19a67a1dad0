"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12   # device memory
F32_FLOPS = 67e12           # float32 outside the tensor cores (TF32 is off)
NUM_SMS = 132
SFU_PER_SM_CLK = 16         # exp2 throughput per SM per clock (compute capability 9.0)
MAX_CLOCK_HZ = 1980e6       # the SM clock at full boost
