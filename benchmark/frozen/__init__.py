"""Frozen copies of the receiver's numpy layers, kept with the benchmark.

``constants``, ``transforms``, ``tropo``, ``kepler``, ``lnav``, ``bits``,
``bitfields``, ``fec``, ``galileo_nav``, ``pseudorange`` and ``lsq`` are
copies of cusdr_tpu_torch's files of those names (constants.py, geodesy/,
orbits/, nav/, pvt/), their imports made local and cut to what the
benchmark uses; ``codes`` and ``loop`` restate the L1 C/A and E5a
generators, code sampling and the loop-filter coefficients.  The traffic
generator and the plain reference use them, so that a change to the
program moves neither.  Nothing here imports the program.
"""
