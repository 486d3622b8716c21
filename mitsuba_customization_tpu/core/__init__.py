"""Core math layer: frames, warps, distributions, transforms, QMC, color.

Analogue of mitsuba3 src/core (libcore) — SURVEY.md §2.3.
Everything here is pure jnp over batched arrays (vectors are (..., 3)).
"""
