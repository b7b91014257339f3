"""Member·sim-years per wall hour: members × steps completed × dt over the
planet's year, over the window's wall time (which ends in a synchronise)."""

from qbench.peaks import HOURS, T_PLANET_S


def read(run):
    return run.n_members * run.steps * run.dt / T_PLANET_S / (run.window_s / HOURS)
