"""Robust LOESS smoothing (Cleveland 1979), batched.

Port of ``xsdba_tpu/ops/loess.py`` (the reference's numba kernel,
``loess.py:16-179``), with its equal-spacing semantics (``loess.py:108-155``):
window ``r = 2*floor(f*n/2)+1``, the bandwidth shrinking at the series
ends, tricube or gaussian weights, biweight robustness iterations.  NaN
points get zero weight instead of being dropped (the JAX package's
documented deviation).

Two cores, chosen as the JAX package chooses them (``n > 4096 or r > 512``
takes the second):

- :func:`_loess_equal_core` gathers each point's window, [..., n, r + 4];
- :func:`_loess_equal_fft_core` computes every point's weighted sums as
  FFT convolutions (interior weights depend only on the offset), then
  recomputes the edge points, where the bandwidth shrinks.  Every left edge
  point's window starts at 0 and every right one's at ``n - R``, so a
  side's weights are one matrix [edge, R] shared by every batch row and its
  weighted sums are one matrix product, where the JAX package loops over
  the points.

The robustness scale is the median of |residuals| averaging the two middle
values, as ``jnp.nanmedian`` does (``torch.nanmedian`` takes the lower).
"""

from __future__ import annotations

import torch

from ..utils.tensor import as_tensor

__all__ = ["loess_smoothing"]

# weight-matrix elements a block of edge points may take (f32: 256 MB), and
# gathered window values a block of batch rows may take (f32: 512 MB)
_EDGE_BUDGET = 1 << 26
_GATHER_BUDGET = 1 << 27


def _tricube(u):
    # reference loess.py:29-34
    w = (1 - u**3) ** 3
    return torch.where(u >= 1, 0.0, w)


def _gaussian(u):
    # reference loess.py:17-26: f spans 95% of the gaussian
    w = torch.exp(-(u**2) / (2 * (1 / 1.96) ** 2))
    return torch.where(u >= 1, 0.0, w)


_WEIGHT_FUNCS = {"tricube": _tricube, "gaussian": _gaussian}


def _window(n: int, f: float):
    """(r, hw, R, HW): the window, its half width, the gathered width and
    the half width of the gathered window (reference loess.py:114-120)."""
    r = min(int(2 * (int(f * n) // 2) + 1), n)
    hw = (r - 1) // 2
    return r, hw, min(r + 4, n), hw + 2


def _bandwidth(i, n: int, r: int, hw: int, dx):
    """The bandwidth h at the points ``i`` (reference loess.py:138-147)."""
    h_left = (r - i).to(dx.dtype) * dx
    h_right = (i - (n - r) + 1).to(dx.dtype) * dx
    return torch.where(i < hw, h_left, torch.where(i >= n - hw, h_right, (hw + 1) * dx))


def _nanmedian(a):
    """Median over the last axis ignoring NaNs, kept as [..., 1]: the two
    middle values averaged (``jnp.nanmedian``'s midpoint); NaN where every
    value is NaN."""
    srt = torch.sort(a, dim=-1, stable=True).values         # NaNs last
    counts = (~torch.isnan(a)).sum(dim=-1, keepdim=True)
    last = (counts - 1).clamp(min=0)
    low = torch.gather(srt, -1, torch.minimum((counts - 1) // 2, last).clamp(min=0))
    high = torch.gather(srt, -1, torch.minimum(counts // 2, last))
    return (low + high) * 0.5


def _robustness(y, est):
    """Biweight robustness weights from the residuals (reference
    loess.py:150-155)."""
    resid = y - est
    s = _nanmedian(resid.abs())
    xres = torch.where(s == 0, (resid != 0).to(y.dtype), resid / torch.where(s == 0, 1, 6.0 * s))
    delta = torch.where(xres.abs() >= 1, 0.0, (1 - xres**2) ** 2)
    return torch.where(torch.isnan(delta), 0.0, delta)


def _spacing(y, x):
    x = as_tensor(x, dtype=y.dtype, device=y.device)
    dx = x[1] - x[0] if y.shape[-1] > 1 else torch.ones((), dtype=y.dtype, device=y.device)
    return x, dx


def _fft_conv(signals, kernel):
    """Linear convolutions of signals [..., n] with kernel [K] by FFT,
    'same'-aligned: out[i] = sum_j kernel[j] * signal[i + K//2 - j] (zero
    padded), at the JAX package's power-of-two length."""
    n = signals.shape[-1]
    K = kernel.shape[0]
    L = n + K - 1
    Lp = 1 << (L - 1).bit_length()
    S = torch.fft.rfft(signals, n=Lp, dim=-1)
    Kf = torch.fft.rfft(kernel, n=Lp)
    conv = torch.fft.irfft(S * Kf, n=Lp, dim=-1)[..., :L]
    h = K // 2
    return conv[..., h : h + n]


def _loess_equal_fft_core(y, x, *, f: float, niter: int, d: int, weights: str):
    """Interior by convolution, edges by one matrix product a side
    (``xsdba_tpu/ops/loess.py:57-157``)."""
    n = y.shape[-1]
    x, dx = _spacing(y, x)
    wfunc = _WEIGHT_FUNCS[weights]
    r, hw, R, HW = _window(n, f)

    # interior kernels over the relative offsets -HW..HW (beyond the
    # bandwidth the weight function gives 0)
    offs = (torch.arange(2 * HW + 1, dtype=y.dtype, device=y.device) - HW) * dx
    w_k = wfunc(offs.abs() / ((hw + 1) * dx))
    kernels = [w_k] if d == 0 else [w_k, w_k * offs, w_k * offs * offs]
    nan = torch.isnan(y)
    y0 = torch.where(nan, 0.0, y)
    valid = (~nan).to(y.dtype)

    def smooth_interior(delta):
        dv = delta * valid
        dy = dv * y0
        both = torch.stack([dv, dy])
        s_w, s_wy = _fft_conv(both, kernels[0])
        if d == 0:
            return s_wy / s_w
        s_wu, s_wuy = _fft_conv(both, kernels[1])
        s_wu2 = _fft_conv(dv, kernels[2])
        det = s_w * s_wu2 - s_wu * s_wu
        # the value at u = 0 is the intercept
        return (s_wu2 * s_wy - s_wu * s_wuy) / det

    # the edge points: left i = 0..edge-1 (window x[0:R]), right
    # i = n-1-k (window x[n-R:n]); their weights do not depend on the data
    edge = min(n, HW + 1)
    k = torch.arange(edge, device=y.device)
    step = max(1, _EDGE_BUDGET // max(R, 1))
    sides = []
    for pts, start in ((k, 0), (n - 1 - k, n - R)):
        xw = x[start : start + R]
        h = _bandwidth(pts, n, r, hw, dx)
        blocks = [
            (pts[c : c + step], wfunc((xw[None, :] - x[pts[c : c + step]][:, None]).abs() / h[c : c + step, None]).T)  # [R, e]
            for c in range(0, edge, step)
        ]
        sides.append((slice(start, start + R), xw, blocks))

    def smooth_edges(delta, est):
        dv = delta * valid
        for win, xw, blocks in sides:
            wv, yw = dv[..., win], y0[..., win]
            # the weighted sums as rows: sw, swy (d = 0); and swx, swx2,
            # swxy (d = 1), with the uncentred x as the JAX package sums them
            rows = [wv, wv * yw] if d == 0 else [wv, wv * yw, wv * xw, wv * xw * xw, wv * xw * yw]
            sig = torch.stack(rows)                                       # [S, ..., R]
            for p, Wt in blocks:
                sums = sig @ Wt                                           # [S, ..., e]
                if d == 0:
                    val = sums[1] / sums[0]
                else:
                    sw, swy, swx, swx2, swxy = sums
                    det = sw * swx2 - swx * swx
                    b1 = (sw * swxy - swx * swy) / det
                    b0 = (swy - b1 * swx) / sw
                    val = b0 + b1 * x[p]
                est[..., p] = val
        return est

    delta = torch.ones_like(y)
    est = smooth_edges(delta, smooth_interior(delta))
    for _ in range(niter - 1):
        delta = _robustness(y, est)
        est = smooth_edges(delta, smooth_interior(delta))
    return torch.where(nan, torch.nan, est)


def _loess_equal_core(y, x, *, f: float, niter: int, d: int, weights: str):
    """Each point's window gathered, [..., n, R] (``xsdba_tpu/ops/loess.py:160-217``)."""
    n = y.shape[-1]
    x, dx = _spacing(y, x)
    wfunc = _WEIGHT_FUNCS[weights]
    r, hw, R, HW = _window(n, f)

    i = torch.arange(n, device=y.device)
    start = torch.clamp(i - HW, 0, n - R)
    win = start[:, None] + torch.arange(R, device=y.device)[None, :]     # [n, R]
    xw = x[win]
    wi = wfunc((xw - x[:, None]).abs() / _bandwidth(i, n, r, hw, dx)[:, None])

    def smooth_rows(yr):
        yw = yr[..., win]                                                # [rows, n, R]
        nanw = torch.isnan(yw)
        yw0 = torch.where(nanw, 0.0, yw)

        def smooth(delta):
            w = wi * delta[..., win] * (~nanw)
            if d == 0:
                return (w * yw0).sum(dim=-1) / w.sum(dim=-1)
            # weighted linear regression evaluated at x_i (loess.py:41-46)
            sw = w.sum(dim=-1)
            swx = (w * xw).sum(dim=-1)
            swx2 = (w * xw * xw).sum(dim=-1)
            swy = (w * yw0).sum(dim=-1)
            swxy = (w * xw * yw0).sum(dim=-1)
            det = sw * swx2 - swx * swx
            b1 = (sw * swxy - swx * swy) / det
            b0 = (swy - b1 * swx) / sw
            return b0 + b1 * x

        est = smooth(torch.ones_like(yr))
        for _ in range(niter - 1):
            est = smooth(_robustness(yr, est))
        return torch.where(torch.isnan(yr), torch.nan, est)

    # the batch rows in blocks of at most _GATHER_BUDGET gathered values
    flat = y.reshape(-1, n)
    rows = max(1, _GATHER_BUDGET // (n * R))
    if flat.shape[0] <= rows:
        return smooth_rows(flat).reshape(y.shape)
    return torch.cat([smooth_rows(flat[c : c + rows]) for c in range(0, flat.shape[0], rows)]).reshape(y.shape)


def loess_smoothing(y, x, f: float = 0.5, niter: int = 2, d: int = 1, weights: str = "tricube"):
    """LOESS-smooth ``y`` [..., n] over the equally spaced coordinate ``x``
    [n] (reference ``loess.py:182-279`` defaults); ``d`` in {0, 1}."""
    if d not in (0, 1):
        raise NotImplementedError("Only d=0 and d=1 are implemented.")
    if weights not in _WEIGHT_FUNCS:
        raise ValueError(f"weights must be one of {sorted(_WEIGHT_FUNCS)}")
    y = as_tensor(y)
    n = y.shape[-1]
    r = int(2 * (int(f * n) // 2) + 1)
    # wide windows: the gathered [n, r + 4] form grows too large
    core = _loess_equal_fft_core if (n > 4096 or r > 512) else _loess_equal_core
    return core(y, x, f=float(f), niter=int(niter), d=int(d), weights=weights)
