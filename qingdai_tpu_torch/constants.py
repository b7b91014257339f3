"""Physical and astronomical constants for the Qingdai simulation.

Values match the reference model (see pygcm/constants.py:9-35)
so that orbital periods, insolation and radiative budgets are bit-comparable.
"""

# --- Physical constants (SI) ---
G = 6.67430e-11       # gravitational constant (m^3 kg^-1 s^-2)
SIGMA = 5.670374e-8   # Stefan-Boltzmann constant (W m^-2 K^-4)

# --- Astronomical units ---
M_SUN = 1.989e30      # kg
L_SUN = 3.828e26      # W
AU = 1.496e11         # m

# --- Harmony binary system ---
M_A = 0.914 * M_SUN   # Star A (G6V)
L_A = 0.7 * L_SUN
M_B = 0.8 * M_SUN     # Star B (K1V)
L_B = 0.410 * L_SUN
M_TOTAL_STARS = M_A + M_B
A_BINARY = 0.5 * AU   # binary semi-major axis

# --- Qingdai planet ---
A_PLANET = 1.32 * AU
PLANET_RADIUS = 6.371e6
PLANET_ALBEDO = 0.3
PLANET_OMEGA = 8.726646259971648e-5  # rad/s (20-hour day)
PLANET_AXIAL_TILT = 27.0             # degrees

# Derived: planetary solar day length (s). 2*pi/omega = 72000 s exactly.
DAY_SECONDS = 2.0 * 3.141592653589793 / PLANET_OMEGA
