"""Batched bi-level motion planner for autonomous vehicles at urban junctions.

A from-scratch rebuild of the capabilities of
``SaeedRahmani/MPC_for_AV_at_Intersection`` (see SURVEY.md) as a batched,
functional, jit-compiled JAX framework:

- ``models``   — vehicle geometry (bicycle / Prius)
- ``core``     — pure-function dynamics, SE(2) transforms, curve ops
- ``worlds``   — parametric junction generators -> padded half-plane arrays
- ``lattice``  — motion-primitive tables + lattice search (host oracle and
                 batched device wavefront)
- ``agents``   — scripted moving agents, prediction, conflict detection
- ``mpc``      — batched condensed-QP tracking controller (ADMM + polish)
- ``engine``   — jitted closed-loop receding-horizon simulation
- ``parallel`` — mesh / shard_map scale-out over the scenario batch
- ``ops``      — hand-written GPU kernels (Pallas, Triton route)
- ``backend``  — per-platform choice of each stage's implementation
"""

__version__ = "0.1.0"
