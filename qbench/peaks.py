"""The yardstick's constants.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): HBM3 at 3.35 TB/s; 67 TFLOP/s in float32
outside the tensor cores. The planet's year, frozen here so that the
benchmark's arithmetic does not move with the program's constants.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# the planet's orbital period in seconds: 2π √(a³ / (G M)) of Qingdai's orbit
T_PLANET_S = 36552113.472493455
HOURS = 3600.0
