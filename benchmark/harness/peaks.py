"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W limit). A card set below 700 W runs slower under load: the
run prints the card's name, and ``PERF.md`` its power limit beside every
number."""

F32_PEAK = 67e12    # float32 FLOP/s outside the tensor cores (TF32 is off)
F64_PEAK = 67e12    # float64 FLOP/s on the tensor cores, the highest float64 rate the card has
HBM_RATE = 3.35e12  # HBM3 bytes/s
