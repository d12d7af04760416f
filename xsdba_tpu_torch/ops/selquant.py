"""Selection-based windowed grouped quantiles (no merge, no per-group sort).

The port of ``xsdba_tpu/ops/selquant.py``, the counting-selection engine of
the windowed grouped type-7 quantile.  The quantile needs only ~2*nq+1 order
statistics per (site, group), not the sorted ``window * years`` row the
merge engine builds, and this module finds them by counting:

1. one sort of each site's series, carrying a packed per-element
   group-interval label (``start * _PACK + length``) as payload: a stable
   ``torch.sort`` plus a gather (``sort_impl="lax"``), or the key–payload
   row sort of ``ops/sort.py`` (``"pallas"``: the CUDA kernel K7 on the
   card, its twin on the CPU; ``"xla"``: the twin).  Windowed membership of
   element ``t`` is the cyclic interval of groups
   ``[start_t, start_t + len_t)`` (checked host-side from the exact gather
   matrix, :func:`interval_membership`);
2. per-block windowed member counts: the sorted row is cut into blocks of
   ``Wb`` elements; each block's per-group count comes from a difference
   array (+1 at an element's first group, -1 past its last, cyclic) summed
   over the groups, and a cumulative sum over blocks gives the exact valid
   count, and so the type-7 ranks, per (site, group);
3. the needed ranks' values, by one of two engines (``mode``):
   ``"gather"``: each rank finds its block by ``torch.searchsorted`` over
   the block counts, the block's values and labels are gathered, and the
   rank's element is picked by a member test and a cumulative count inside
   the block; ``"emit"``: the reference's dense emission, the sorted row
   re-scanned chunk by chunk, each element testing its member rank against
   the ranks its chunk holds (``ops/cuda/emit_kernel.py``: the hand-written
   kernel ``csrc/emit_kernel.cu`` on a CUDA tensor, which stores no hit
   tensor, and the reference's form under an element budget, its twin, on
   the CPU).

The counts are exact for NaN data too (NaNs sort last and are no members),
so one program covers finite and NaN data.  The selected elements are the
floats the sorted window would hold (a selected -0.0 as +0.0, as the
reference's sums give it), and the rank and lerp arithmetic mirrors the
reference op for op, so both engines equal each other, the reference's
engines and its re-sort oracle bit for bit on the CPU.  The merge engine
(``ops/merge.py``) instead gives a selected zero the sign its rows hold in
IEEE totalOrder, as the reference's merge kernels do: the two engines of
either package can give a zero, and a ``kind="*"`` factor over it an
infinity, of different sign.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..utils.tensor import upload
from . import sort
from .cuda import emit_kernel
from .quantile import _lerp, _virtual_index

__all__ = [
    "default_mode",
    "default_sort_impl",
    "interval_membership",
    "pack_labels",
    "selection_ok",
    "selection_windowed_quantile",
    "selection_windowed_quantile_core",
]

# labels are packed as start*_PACK + length; _PACK must exceed any group count
_PACK = 1024


def selection_ok(plan, quantiles, device) -> bool:
    """True when the counting-selection engine serves this call on
    ``device``: the ``selection_backend`` option is on, the plan has
    interval labels and the quantiles are one row.  The CPU selects by
    default; CUDA only under ``selection_on_tpu=True`` (the option keeps the
    reference's name, so one ``set_options`` call means the same in both
    packages), and otherwise takes the merge engine."""
    from ..utils.options import get_option

    if not (
        get_option("selection_backend")
        and plan is not None
        and plan.sel_labels is not None
        and np.ndim(quantiles) == 1
    ):
        return False
    return get_option("selection_on_tpu") or torch.device(device).type == "cpu"


def interval_membership(gather_idx, n_groups: int, T: int):
    """Host-side inversion of a [G, L] gather matrix into per-element cyclic
    group intervals, or None when membership is not interval-shaped.

    Returns ``(start, length)`` int32 arrays of shape [T]: element ``t`` is a
    member of groups ``{(start[t] + j) % G : j < length[t]}``.  Valid only
    when every element's member-group set is a single cyclic interval and the
    gather matrix holds no duplicate entries (both checked).  Rolling doy/5D
    windows on regular calendars pass; leap/standard calendars (the doy
    sequence skips a value in most years) fail and keep the merge path.
    """
    gi = np.asarray(gather_idx)
    G = int(n_groups)
    mem = np.zeros((T, G), dtype=bool)
    n_entries = 0
    for g in range(G):
        m = gi[g]
        m = m[m >= 0]
        n_entries += len(m)
        mem[m, g] = True
    if n_entries != int(mem.sum()):  # duplicate entries: counts would be off
        return None
    cnt = mem.sum(axis=1)
    starts01 = mem & ~np.roll(mem, 1, axis=1)
    ns = starts01.sum(axis=1)
    full = cnt == G
    if not np.all((ns == 1) | (cnt == 0) | full):
        return None
    start = np.argmax(starts01, axis=1).astype(np.int32)
    start[full | (cnt == 0)] = 0
    if G >= _PACK or T >= (1 << 22):  # packed label must fit int32 exactly
        return None
    return start, cnt.astype(np.int32)


def pack_labels(start, length) -> np.ndarray:
    """Pack host interval arrays into the single int32 label the core sorts."""
    return (np.asarray(start, np.int32) * _PACK + np.asarray(length, np.int32)).astype(
        np.int32
    )


def _sort_stage(xb, lab, sort_impl: str):
    """Stage 1: each row sorted, NaNs last (``"lax"``) or as (+inf, 0)
    pairs (the row sort), the labels riding along.  Returns the sorted
    values and labels, [B, T'] with T' >= T."""
    if sort_impl == "lax":
        svals, order = torch.sort(xb, dim=-1, stable=True)
        return svals, torch.gather(lab, -1, order)
    if sort_impl not in ("pallas", "xla"):
        raise ValueError(f"Unknown selection sort {sort_impl!r} (lax, pallas, xla).")
    # the row sort cannot carry NaN keys: (+inf, label 0) keeps the element
    # out of every count, exactly as a NaN sorted last would be
    bad = torch.isnan(xb)
    key = torch.where(bad, torch.inf, xb)
    lab = torch.where(bad, 0, lab)
    fn = sort.sort_rows_with_payload if sort_impl == "pallas" else sort.sort_rows_with_payload_reference
    return fn(key, lab)


def _block_counts(svals, slab, G: int, nb: int, Wb: int):
    """Stage 2a: members of each group in each block, [B, nb, G] int32.

    An element of label (a, l) is a member of groups a .. a+l-1 (mod G):
    +1 at a and -1 at a+l in a difference array over G+1 columns (the wrap
    split into [a, G) and [0, a+l-G)), summed over the groups."""
    B = svals.shape[0]
    a = slab // _PACK
    ln = slab % _PACK
    w = (~torch.isnan(svals)).to(torch.int32)
    end = a + ln
    wrap = end > G
    blk = ((torch.arange(svals.shape[1], device=svals.device) // Wb) * (G + 1)).expand(B, -1)
    idx = torch.cat([blk + a, blk + torch.clamp(end, max=G), blk + torch.where(wrap, end - G, 0), blk], dim=1)
    wv = torch.where(wrap, w, 0)
    val = torch.cat([w, -w, -wv, wv], dim=1)
    diff = torch.zeros((B, nb * (G + 1)), dtype=torch.int32, device=svals.device)
    diff.scatter_add_(1, idx, val)
    return torch.cumsum(diff.reshape(B, nb, G + 1), dim=-1, dtype=torch.int32)[..., :G]


def _counted(x, labels, quantiles, G, Wb, nb_chunk, sort_impl, alpha, beta):
    """Stages 1 and 2a and the target ranks, shared by both engines: the
    sorted rows and labels [B, Tp] (padded with (NaN, 0) to whole chunks of
    ``nb_chunk`` blocks), the inclusive block counts C [B, nb, G], the
    valid counts n [B, G], and per (row, group, sorted quantile) the lerp
    weight and the left and right ranks; then the permutation that puts the
    quantile columns back in the caller's order."""
    T = x.shape[-1]
    B = int(np.prod(x.shape[:-1], dtype=np.int64))
    xb = x.reshape(B, T)
    q = torch.as_tensor(quantiles, dtype=x.dtype, device=x.device)
    # each quantile is computed on its own: sort q as the reference does and
    # un-permute the columns at the end
    q_order = torch.argsort(q)
    q_inv = torch.argsort(q_order)
    q = q[q_order]

    # --- stage 1: one sort per site, labels ride as payload (NaNs last) ---
    lab = labels.to(torch.int32).expand(B, T)
    svals, slab = _sort_stage(xb, lab, sort_impl)
    T = svals.shape[-1]
    nb = -(-T // (Wb * nb_chunk)) * nb_chunk
    Tp = nb * Wb
    if Tp > T:
        svals = torch.nn.functional.pad(svals, (0, Tp - T), value=torch.nan)
        slab = torch.nn.functional.pad(slab, (0, Tp - T))  # length 0 -> never member

    # --- stage 2a: per-block member counts, cumulated over blocks ---
    C = torch.cumsum(_block_counts(svals, slab, G, nb, Wb), dim=1, dtype=torch.int32)  # [B, nb, G]
    n = C[:, -1, :]                                                                      # [B, G]

    # --- target ranks: mirrors _quantile_on_sorted's virtual-index math ---
    v = n[..., None].to(x.dtype)                         # [B, G, 1]
    vi = _virtual_index(v, q, alpha, beta)               # [B, G, nq]
    prev = torch.floor(vi)
    above = vi >= v - 1
    below = vi < 0
    pi = prev.to(torch.int32)
    nmax = torch.clamp(n, min=1)[..., None]
    one = torch.ones_like(pi)
    r_left = torch.where(above, nmax, torch.where(below, one, pi + 1))
    r_right = torch.where(above, nmax, torch.where(below, one, pi + 2))
    return svals, slab, C, n, vi - prev, r_left, r_right, q_inv


def _chunk_starts(C, nb_chunk):
    """Members of each group before each chunk of ``nb_chunk`` blocks,
    [B, nchunk, G], from the inclusive block counts C [B, nb, G]."""
    return torch.cat([torch.zeros_like(C[:, :1]), C[:, nb_chunk - 1 : -1 : nb_chunk]], dim=1)


def _emit_operands(x, labels, quantiles, *, G, Wb=64, nb_chunk=128, sort_impl="lax", alpha=1.0, beta=1.0):
    """What the emission (``ops/cuda/emit_kernel.py:emit``) is given for
    ``x`` [..., T]: (svals, slab, clo, r_left, r_right, n, chunk)."""
    svals, slab, C, n, _, r_left, r_right, _ = _counted(x, labels, quantiles, G, Wb, nb_chunk, sort_impl, alpha, beta)
    return svals, slab, _chunk_starts(C, nb_chunk), r_left, r_right, n, Wb * nb_chunk


def selection_windowed_quantile_core(
    x,
    labels,
    quantiles,
    *,
    G: int,
    Wb: int = 64,
    nb_chunk: int = 128,
    slots: int = 32,
    g_chunk: int = 64,
    mode: str = "emit",
    sort_impl: str = "lax",
    alpha: float = 1.0,
    beta: float = 1.0,
):
    """``x`` [..., T] values, ``labels`` [T] packed ``start*_PACK + length``
    int32 (on x's device), ``quantiles`` [nq].  Returns [..., G, nq].

    ``mode`` is the extraction engine (module doc): ``"emit"`` (the dense
    emission, the reference's default here) or ``"gather"`` (per-query
    block gather and in-block pick); both give the same floats.
    ``sort_impl`` picks the stage-1 sort (module doc).  ``Wb`` is the
    sorted-order block width, ``nb_chunk`` the blocks of an emission chunk
    (the sorted row is padded to a whole number of chunks), ``slots`` the
    ranks a chunk's emission tests a group at once on the CPU (more reruns
    the emission at nq slots; the kernel needs none) and ``g_chunk`` the
    groups each gather chunk gathers for: performance knobs, free of
    semantics.
    """
    if mode not in ("emit", "gather"):
        raise ValueError(f"Unknown selection mode {mode!r} (emit, gather).")
    lead = x.shape[:-1]
    svals, slab, C, n, gamma, r_left, r_right, q_inv = _counted(x, labels, quantiles, G, Wb, nb_chunk, sort_impl, alpha, beta)
    if mode == "emit":
        # --- stages 2b + 3: dense emission over chunks of nb_chunk blocks ---
        left, right, maxv = emit_kernel.emit(svals, slab, _chunk_starts(C, nb_chunk), r_left, r_right, n, Wb * nb_chunk, slots)
        return _finish(left, right, maxv[..., None], gamma, n, q_inv, lead)
    B, nb = C.shape[:2]
    nq = r_left.shape[-1]
    nmax = torch.clamp(n, min=1)[..., None]
    # K = 2*nq + 1 rank queries; the last selects the max valid value (rank
    # n) used by the NaN-range clip (nbutils.py:144-147)
    r = torch.cat([r_left, r_right, nmax], dim=-1)       # [B, G, K]
    K = 2 * nq + 1

    # --- stage 2b: containing block (first with C >= r) and local rank ---
    Ct = C.transpose(1, 2).contiguous()                  # [B, G, nb] non-decreasing
    bstar = torch.searchsorted(Ct, r.contiguous())       # #blocks with C < r
    cprev = torch.gather(Ct, -1, torch.clamp(bstar - 1, min=0))
    cprev = torch.where(bstar > 0, cprev, 0)
    m = r - cprev                                        # local member rank
    bstar = torch.clamp(bstar, max=nb - 1)               # n == 0 rows: clamp

    # --- stage 3: gather ONE block per query, pick the m-th member ---
    rows = (torch.arange(B, device=x.device) * nb)[:, None, None]
    sv_blocks = svals.reshape(B * nb, Wb)
    sl_blocks = slab.reshape(B * nb, Wb)
    g_all = torch.arange(G, device=x.device)
    val = torch.empty((B, G, K), dtype=x.dtype, device=x.device)
    for g0 in range(0, G, g_chunk):
        gs = slice(g0, min(g0 + g_chunk, G))
        flat = (rows + bstar[:, gs]).reshape(-1)
        vals_w = sv_blocks.index_select(0, flat).reshape(B, -1, K, Wb)
        lab_w = sl_blocks.index_select(0, flat).reshape(B, -1, K, Wb)
        dq = g_all[gs][None, :, None, None] - lab_w // _PACK
        dq = dq + torch.where(dq < 0, G, 0)
        member = (dq < lab_w % _PACK) & ~torch.isnan(vals_w)
        csum = torch.cumsum(member, dim=-1, dtype=torch.int32)
        pick = member & (csum == m[:, gs, :, None])
        val[:, gs] = torch.sum(torch.where(pick, vals_w, 0), dim=-1)

    return _finish(val[..., :nq], val[..., nq : 2 * nq], val[..., 2 * nq :], gamma, n, q_inv, lead)


def _finish(left, right, maxv, gamma, n, q_inv, lead):
    """The type-7 lerp of the selected values, clipped to the largest valid
    value where it is NaN (nbutils.py:144-147), NaN where a group has no
    valid value, the quantile columns back in the caller's order."""
    interp = _lerp(left, right, gamma)
    out = torch.where(torch.isnan(interp), maxv, interp)
    out = torch.where((n == 0)[..., None], torch.nan, out)
    return out[..., q_inv].reshape(lead + out.shape[1:])


def default_mode(device) -> str:
    """Extraction engine from the ``selection_mode`` option for data on
    ``device``: ``"auto"`` resolves as the reference resolves it per
    backend, ``"gather"`` on the CPU, where gathers are cheap, and
    ``"emit"`` elsewhere (CUDA: the emission kernel, whose fused step at 224
    sites is under a tenth of gather's on the H100, ``chip_smoke.py`` phase 6);
    ``"emit"`` and ``"gather"`` select themselves."""
    from ..utils.options import get_option

    mode = get_option("selection_mode")
    if mode != "auto":
        return mode
    return "gather" if torch.device(device).type == "cpu" else "emit"


def default_sort_impl(dtype, device) -> str:
    """Stage-1 sort from the ``selection_sort`` option: ``"auto"`` takes
    the row sort's CUDA kernel (K7, ``"pallas"``) for float32 on CUDA and
    the stable ``torch.sort`` (``"lax"``) elsewhere."""
    from ..utils.options import get_option

    impl = get_option("selection_sort")
    if impl != "auto":
        return impl
    return "pallas" if torch.device(device).type == "cuda" and dtype == torch.float32 else "lax"


def max_chunk(G: int, nq: int, T: int, Wb: int = 64, mode: str = "gather", nb_chunk: int = 128) -> int:
    """Sites per call.  The gather engine keeps its stage-3 block gather
    [B, G, K, 2*Wb] and the block counts near 2^31 elements, as the
    reference bounds both engines.  The emit engine's stages 2b and 3 hold
    no such tensor, so its bound is stage 2a's: about three int32 copies of
    the block counts [B, nb, G + 1] and sixteen words a value of the padded
    sorted rows, kept within 2^28 words (1 GiB)."""
    if mode == "emit":
        E = Wb * nb_chunk
        Tp = -(-sort.padded_length(T) // E) * E
        per_site = 3 * (Tp // Wb) * (G + 1) + 16 * Tp
        return max(1, (1 << 28) // per_site)
    K = 2 * nq + 1
    per_site = G * K * 2 * Wb + 2 * (-(-T // Wb)) * G
    return max(1, (1 << 31) // max(per_site, 1))


def selection_windowed_quantile(
    x,
    plan,
    quantiles,
    alpha: float = 1.0,
    beta: float = 1.0,
    Wb: int = 64,
    nb_chunk: int = 128,
    slots: int = 32,
    g_chunk: int = 64,
    mode: str | None = None,
    sort_impl: str | None = None,
):
    """Windowed grouped quantile via counting selection (see module doc).

    ``plan`` is a :class:`~xsdba_tpu_torch.utils.grouper.WindowMergePlan`
    whose ``sel_labels`` is not None; ``x`` [..., T] a tensor.  Returns
    [..., G, nq], equal to the re-sort oracle (``grouped_nan_quantile`` of
    the plan's gather matrix) in the selected elements.  ``mode`` is the
    extraction engine (``selection_mode`` for x's device by default:
    :func:`default_mode`).
    ``Wb``, ``nb_chunk``, ``slots`` and ``g_chunk`` size the blocks, chunks
    and slots (:func:`selection_windowed_quantile_core`); they change no
    result."""
    if plan.sel_labels is None:
        raise ValueError("plan has no interval membership; use the merge path")
    G = int(plan.fast_mask.shape[0])
    lab = plan_labels(plan, x.device)
    mode = default_mode(x.device) if mode is None else mode
    sort_impl = default_sort_impl(x.dtype, x.device) if sort_impl is None else sort_impl
    lead = x.shape[:-1]
    B = int(np.prod(lead, dtype=np.int64))
    chunk = max_chunk(G, int(np.shape(quantiles)[0]), x.shape[-1], Wb, mode, nb_chunk)

    def run(xc):
        return selection_windowed_quantile_core(
            xc, lab, quantiles, G=G, Wb=Wb, nb_chunk=nb_chunk, slots=slots, g_chunk=g_chunk, mode=mode, sort_impl=sort_impl,
            alpha=alpha, beta=beta,
        )

    if B <= chunk:
        return run(x)
    xf = x.reshape(B, x.shape[-1])
    out = torch.cat([run(xf[i : i + chunk]) for i in range(0, B, chunk)], dim=0)
    return out.reshape(lead + out.shape[1:])


_LABEL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def plan_labels(plan, device):
    """A plan's packed labels on ``device``, cached per plan and device
    (plans are long-lived, cached on their TimeIndex)."""
    per_plan = _LABEL_CACHE.setdefault(plan, {})
    key = torch.device(device)
    hit = per_plan.get(key)
    if hit is None:
        hit = per_plan[key] = upload(plan.sel_labels, dtype=torch.int32, device=key)
    return hit
