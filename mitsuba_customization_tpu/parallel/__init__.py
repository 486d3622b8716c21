"""Multi-chip / multi-host parallel rendering.

Replacement for the Mitsuba 0.6 distributed scheduler
(SURVEY.md §2.6 K3, §2.8): instead of a TCP star of mtssrv workers, rays
shard over a jax.sharding.Mesh and gradients all-reduce over ICI.
"""
