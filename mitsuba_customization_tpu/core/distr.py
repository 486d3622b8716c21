"""Tabulated sampling distributions (1-D and 2-D CDF inversion).

Counterpart of mitsuba3 include/mitsuba/core/distr_1d.h
(DiscreteDistribution / ContinuousDistribution) and distr_2d.h (Marginal2D)
— SURVEY.md §2.3. These back emitter selection, mesh-area sampling, and the
MERL luminance-weighted importance sampler (SURVEY.md §3.3).

Design notes:
* Everything is jittable, including CDF *construction* — the inverse-rendering
  loop rebuilds the MERL sampling CDF after every table update
  (SURVEY.md §7.3 item 6), so builds must live inside the jitted step.
* CDF inversion uses a broadcast compare-and-reduce rather than binary
  search: for the table sizes here (<= 256 bins) one fused compare+sum
  per lane, with no data-dependent control flow.
* Distributions are NamedTuples of arrays (pytrees), with optional leading
  "slice" axes so a stack of conditional tables (e.g. one per incident-angle
  bin) is sampled with a per-lane slice index gather.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_TINY = 1e-20


def _searchsorted(cdf, u):
    """Find smallest i with cdf[..., i] >= u; batched over leading axes.

    cdf: (..., K) nondecreasing, ending at ~1. u: (...). Returns int32 (...)
    in [0, K-1]. Implemented as sum(cdf < u) — fuses into one VPU reduction.
    """
    idx = jnp.sum((cdf < u[..., None]).astype(jnp.int32), axis=-1)
    return jnp.clip(idx, 0, cdf.shape[-1] - 1)


_BIG = 3e38


def _invert_cdf(cdf, u):
    """CDF inversion: (idx, lo, mass).

    idx = smallest i with cdf[i] >= u; lo = cdf[idx-1] (0 at idx 0);
    mass = cdf[idx] - lo. All three come from masked reductions over the
    (..., K) row, which the row's own reads already paid for.
    """
    below = cdf < u[..., None]
    idx = jnp.clip(
        jnp.sum(below.astype(jnp.int32), axis=-1), 0, cdf.shape[-1] - 1
    )
    lo = jnp.max(jnp.where(below, cdf, 0.0), axis=-1)
    hi = jnp.min(jnp.where(below, _BIG, cdf), axis=-1)
    hi = jnp.where(hi >= _BIG, cdf[..., -1], hi)
    # u beyond cdf[-1] (fp slack at the top): collapse to the last cell
    lo = jnp.minimum(lo, hi)
    return idx, lo, hi - lo


def _select_at(rows, idx):
    """rows (..., K) at per-lane idx (...) -> (...) via iota-compare+sum.

    Selection from a row each lane has already fetched.
    """
    k = rows.shape[-1]
    iota = jax.lax.broadcasted_iota(jnp.int32, rows.shape, rows.ndim - 1)
    return jnp.sum(
        jnp.where(iota == idx[..., None], rows, 0.0), axis=-1
    )


def _gather_last(arr, idx):
    """arr (..., K) gathered at idx (...) -> (...)."""
    if arr.ndim == 1:
        return arr[jnp.clip(idx, 0, arr.shape[0] - 1)]
    arr_b = jnp.broadcast_to(arr, idx.shape + arr.shape[-1:])
    return _select_at(arr_b, idx)


def _gather_row(arr, idx):
    """arr (..., H, W) gathered at row idx (...) -> (..., W).

    Shared 2-D table: contiguous row-gather. Batched tables fall back to
    the broadcast path (callers keep H*W small there).
    """
    if arr.ndim == 2:
        return arr[jnp.clip(idx, 0, arr.shape[0] - 1)]
    arr_b = jnp.broadcast_to(arr, idx.shape + arr.shape[-2:])
    return jnp.take_along_axis(arr_b, idx[..., None, None], axis=-2)[..., 0, :]


# --------------------------------------------------------------------------
# 1-D discrete distribution (emitter/face selection)
# --------------------------------------------------------------------------


class DiscreteDistribution(NamedTuple):
    """Normalized discrete distribution over K outcomes.

    pmf: (..., K) probabilities summing to 1; cdf: (..., K) inclusive cumsum.
    """

    pmf: jnp.ndarray
    cdf: jnp.ndarray

    @staticmethod
    def build(weights):
        w = jnp.maximum(weights, 0.0) + _TINY
        total = jnp.sum(w, axis=-1, keepdims=True)
        pmf = w / total
        return DiscreteDistribution(pmf=pmf, cdf=jnp.cumsum(pmf, axis=-1))

    def gather_slice(self, idx):
        """Select per-lane rows from a stacked distribution (..., K).

        NOTE: materializes (lanes, K); for large K prefer the lazy `slice_`
        keyword of sample/eval_pmf, which chains gathers without building
        per-lane tables.
        """
        return DiscreteDistribution(pmf=self.pmf[idx], cdf=self.cdf[idx])

    def _rows(self, slice_):
        """cdf/pmf rows, per lane when `slice_` indexes a stack."""
        if slice_ is None:
            return self.pmf, self.cdf
        return self.pmf[slice_], self.cdf[slice_]

    def sample(self, u, slice_=None):
        """u in [0,1) -> outcome index."""
        _, cdf = self._rows(slice_)
        return _searchsorted(cdf, u)

    def sample_reuse(self, u, slice_=None):
        """Sample an index and re-uniformize the used random number.

        Mirrors DiscreteDistribution::sample_reuse — the returned u' is
        uniform in [0,1) again, so one random dimension is recycled.
        """
        _, cdf = self._rows(slice_)
        idx, lo, p = _invert_cdf(cdf, u)
        u2 = jnp.clip((u - lo) / jnp.maximum(p, _TINY), 0.0, 1.0 - 1e-7)
        return idx, u2

    def eval_pmf(self, idx, slice_=None):
        if slice_ is None:
            return _gather_last(self.pmf, idx)
        return self.pmf[slice_ + (idx,)]


# --------------------------------------------------------------------------
# 1-D continuous (piecewise-linear) distribution
# --------------------------------------------------------------------------


class ContinuousDistribution(NamedTuple):
    """Piecewise-constant density on [0, 1) over K cells.

    pdf: (..., K) density values (integrate to 1 over [0,1));
    cdf: (..., K) inclusive cumulative cell masses.
    """

    pdf: jnp.ndarray
    cdf: jnp.ndarray

    @staticmethod
    def build(weights):
        k = weights.shape[-1]
        w = jnp.maximum(weights, 0.0) + _TINY
        total = jnp.sum(w, axis=-1, keepdims=True)
        mass = w / total
        return ContinuousDistribution(pdf=mass * k, cdf=jnp.cumsum(mass, axis=-1))

    def sample(self, u):
        """u in [0,1) -> x in [0,1), continuous (uniform within cell)."""
        k = self.pdf.shape[-1]
        idx, lo, mass = _invert_cdf(self.cdf, u)
        frac = jnp.clip((u - lo) / jnp.maximum(mass, _TINY), 0.0, 1.0 - 1e-7)
        return (idx.astype(jnp.float32) + frac) / k

    def eval_pdf(self, x):
        k = self.pdf.shape[-1]
        idx = jnp.clip((x * k).astype(jnp.int32), 0, k - 1)
        return _gather_last(self.pdf, idx)


# --------------------------------------------------------------------------
# 2-D marginal distribution (Marginal2D analogue)
# --------------------------------------------------------------------------


class Marginal2D(NamedTuple):
    """Piecewise-constant 2-D density on the unit square, row-marginalized.

    Counterpart of mitsuba3 Marginal2D<0> (distr_2d.h): sample the row
    (y / first axis) from the marginal CDF, then the column (x / second
    axis) from the per-row conditional CDF. Tables may carry leading slice
    axes (e.g. one table per incident-angle bin); use `gather_slice` to
    pick per-lane tables before sampling.

    pdf:      (..., H, W) density over [0,1)^2 (integrates to 1)
    cdf_row:  (..., H)    marginal CDF over rows
    cdf_cond: (..., H, W) conditional CDF within each row
    """

    pdf: jnp.ndarray
    cdf_row: jnp.ndarray
    cdf_cond: jnp.ndarray

    @staticmethod
    def build(weights):
        h, w_ = weights.shape[-2], weights.shape[-1]
        w = jnp.maximum(weights, 0.0) + _TINY
        row_mass = jnp.sum(w, axis=-1)  # (..., H)
        total = jnp.sum(row_mass, axis=-1, keepdims=True)  # (..., 1)
        pdf = w / total[..., None] * (h * w_)
        cdf_row = jnp.cumsum(row_mass / total, axis=-1)
        cdf_cond = jnp.cumsum(w / jnp.maximum(row_mass, _TINY)[..., None], axis=-1)
        return Marginal2D(pdf=pdf, cdf_row=cdf_row, cdf_cond=cdf_cond)

    def gather_slice(self, idx):
        """Select per-lane tables from a stack: idx into the leading axes.

        NOTE: materializes (lanes, H, W) tables — 16 GB at 1M lanes for a
        64x64 grid. Hot paths must instead pass `slice_` (a tuple of
        per-lane index arrays into the stack axes) to sample/eval_pdf,
        which chain the gathers index-by-index and never build per-lane
        tables (the memory contract of the MERL sampler).
        """
        return Marginal2D(
            pdf=self.pdf[idx],
            cdf_row=self.cdf_row[idx],
            cdf_cond=self.cdf_cond[idx],
        )

    def sample(self, sample2, slice_=None):
        """sample2 (..., 2) in [0,1)^2 -> ((..., 2) position, pdf).

        slice_: optional tuple of per-lane index arrays selecting tables
        from leading stack axes (lazy; see gather_slice note).
        """
        h, w = self.pdf.shape[-2], self.pdf.shape[-1]
        u_row, u_col = sample2[..., 0], sample2[..., 1]

        # Per-lane table rows are row gathers; the inversions are masked
        # reductions (_invert_cdf) and the sample's pdf falls out of the
        # CDF masses.
        cdf_row = self.cdf_row if slice_ is None else self.cdf_row[slice_]
        row, row_lo, row_mass = _invert_cdf(cdf_row, u_row)
        dy = jnp.clip((u_row - row_lo) / jnp.maximum(row_mass, _TINY), 0.0, 1.0 - 1e-7)

        if slice_ is None:
            cond = _gather_row(self.cdf_cond, row)  # (..., W)
        else:
            cond = self.cdf_cond[slice_ + (row,)]
        col, col_lo, col_mass = _invert_cdf(cond, u_col)
        dx = jnp.clip((u_col - col_lo) / jnp.maximum(col_mass, _TINY), 0.0, 1.0 - 1e-7)

        y = (row.astype(jnp.float32) + dy) / h
        x = (col.astype(jnp.float32) + dx) / w
        pos = jnp.stack([y, x], axis=-1)
        # pdf(cell) = row_mass * cond_mass * H * W (cdf diffs — no lookup)
        pdf = row_mass * col_mass * (h * w)
        return pos, pdf

    def eval_pdf(self, pos, slice_=None):
        """Density at pos (..., 2) = (y, x) in [0,1)^2.

        Computed from CDF differences at the cell:
        pdf = (cdf_row[r] - cdf_row[r-1]) * (cond[r, c] - cond[r, c-1]) * HW.
        """
        h, w = self.pdf.shape[-2], self.pdf.shape[-1]
        row = jnp.clip((pos[..., 0] * h).astype(jnp.int32), 0, h - 1)
        col = jnp.clip((pos[..., 1] * w).astype(jnp.int32), 0, w - 1)
        cdf_row = self.cdf_row if slice_ is None else self.cdf_row[slice_]
        cdf_row = jnp.broadcast_to(cdf_row, row.shape + cdf_row.shape[-1:])
        row_mass = _select_at(cdf_row, row) - _select_at(
            cdf_row, jnp.maximum(row - 1, 0)
        ) * (row > 0)
        if slice_ is None:
            cond = _gather_row(self.cdf_cond, row)
        else:
            cond = self.cdf_cond[slice_ + (row,)]
        col_mass = _select_at(cond, col) - _select_at(
            cond, jnp.maximum(col - 1, 0)
        ) * (col > 0)
        return row_mass * col_mass * (h * w)
