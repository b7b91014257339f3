"""The plain reference of the benchmark: a frozen copy of the port's step
path (model, dynamics, ocean, physics, ecology, routing, ops, grid, state,
config, constants, topography, hydro_network) with only the plain versions
of the kernels and the single-rank forms of the collectives.

It imports torch, numpy and scipy and nothing of the measured package, of
the JAX package or of JAX. It builds its own world (river network, maps,
initial state) from the inputs the benchmark hands it, and is what the
benchmark's ``correct`` holds the measured step to.
"""
