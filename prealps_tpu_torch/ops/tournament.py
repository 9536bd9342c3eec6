"""Tournament pivoting: communication-avoiding column selection, TP-QR, TP-CUR.

Counterpart of ``prealps_tpu/ops/tournament.py`` (reference:
utils/iterativeKernels/tournamentPivoting{,QR,CUR}.c — a binary reduction
tree where each node runs a rank-revealing QR on its candidate columns and
passes the k winners up). The rank-revealing step is QR with column
pivoting done as a diagonal-pivoted Cholesky of the candidates' Gram
(``ops/blockops.py::pivoted_cholesky``, the JAX loop step for step: the
largest residual diagonal, the first on ties). The tree combines winners
pairwise, so log2(P) rounds select k columns of the whole matrix.

Two departures, both in ``qrcp_select``:

* The R-Gram and its pivoted Cholesky run in float64 always. The JAX
  package does so only when ``jax_enable_x64`` is on (its CPU tests); the
  TPU runs them in f32. The card does f64, so the port takes the f64 path
  everywhere.
* The pivoted Cholesky stops after its k pivots (``steps=k``): a later
  step never moves an earlier pivot, so the selection is the full loop's,
  and TP-CUR's row tournament, whose leaves are thousands of columns
  wide, costs k steps instead of one per column.

``tp_cur``'s pseudo-inverses take JAX's default cutoff, rtol =
10·max(m, n)·eps (``jnp.linalg.pinv``), passed explicitly: torch's default
is max(m, n)·eps.

The single-device forms take ``timers`` (``utils/timing.py::Timers``,
None by default): each step (``tournament_select``, ``tsqr``, ``_pinv``,
``pivoted_cholesky``) then adds its time there, nested steps inside their
callers'.
"""

from __future__ import annotations

import torch

from prealps_tpu_torch.ops.blockops import pivoted_cholesky
from prealps_tpu_torch.ops.tsqr import tsqr, tsqr_r
from prealps_tpu_torch.parallel.mesh import all_gather
from prealps_tpu_torch.utils.timing import timed


def qrcp_select(panel: torch.Tensor, k: int, timers=None) -> torch.Tensor:
    """Indices (k,) of k rank-revealing columns of ``panel`` (m, c).

    Diagonal-pivoted Cholesky of the Gram matrix — the same pivot order as
    Householder QRCP (both greedily maximise the residual column norm). A
    TSQR pass comes first when m > c, so the Gram is formed from the small
    (c, c) R factor and its accumulation error grows with c, not m; the
    Gram and the pivoting then run in float64 (module docstring).
    Greedy column-norm pivoting carries no strong-RRQR guarantee
    (adversarial Kahan-type matrices), as the reference's leaf QR.
    """
    m, c = panel.shape
    work = panel
    if m > c:
        work = tsqr_r(panel, nblocks=max(1, min(8, m // max(c, 1))))
    work = work.to(torch.float64)
    g = work.mT @ work
    with timed(timers, "pivoted_cholesky"):
        _, piv, _ = pivoted_cholesky(g, -1.0, steps=k)
    return piv[:k]


def tournament_select(a: torch.Tensor, k: int, nblocks: int = 8,
                      timers=None) -> torch.Tensor:
    """Select k columns of a (m, n) by tournament pivoting. Returns global
    column indices (k,), deterministic."""
    m, n = a.shape
    nblocks = int(min(nblocks, max(1, n // max(k, 1))))
    cb = -(-n // nblocks)
    pad = nblocks * cb - n
    if pad:
        a = torch.cat([a, a.new_zeros((m, pad))], dim=1)
    # leaf round: winners per block
    cols = torch.arange(nblocks * cb, device=a.device).reshape(nblocks, cb)
    winners = [cols[b, qrcp_select(a[:, b * cb:(b + 1) * cb], min(k, cb), timers)]
               for b in range(nblocks)]
    # tree rounds
    while len(winners) > 1:
        nxt = []
        for i in range(0, len(winners) - 1, 2):
            cand = torch.cat([winners[i], winners[i + 1]])
            nxt.append(cand[qrcp_select(a[:, cand], min(k, cand.shape[0]), timers)])
        if len(winners) % 2 == 1:
            nxt.append(winners[-1])
        winners = nxt
    return winners[0][:k]


def tp_qr(a: torch.Tensor, k: int, nblocks: int = 8, timers=None):
    """Tournament-pivoting QR: A ≈ Q R[:, perm] with k selected columns
    leading. Returns (q, r, cols): q (m, k), r (k, n), cols (k,).

    (reference: utils/iterativeKernels/tournamentPivotingQR.c)"""
    with timed(timers, "tournament_select"):
        cols = tournament_select(a, k, nblocks, timers)
    with timed(timers, "tsqr"):
        q, _ = tsqr(a[:, cols], nblocks=nblocks)
    return q, q.mT @ a, cols


def _pinv(x: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse at ``jnp.linalg.pinv``'s default cutoff."""
    rtol = 10.0 * max(x.shape) * torch.finfo(x.dtype).eps
    return torch.linalg.pinv(x, rtol=rtol)


def tp_cur(a: torch.Tensor, k: int, nblocks: int = 8, timers=None):
    """Tournament-pivoting CUR: A ≈ C U R with C = k columns and R = k rows
    of A. Returns (c, u, r, cols, rows).

    (reference: utils/iterativeKernels/tournamentPivotingCUR.c)"""
    with timed(timers, "tournament_select"):
        cols = tournament_select(a, k, nblocks, timers)
    with timed(timers, "tournament_select"):
        rows = tournament_select(a.mT, k, nblocks, timers)
    c = a[:, cols]
    r = a[rows, :]
    # U = C⁺ A R⁺ via least squares through the selected cross block
    with timed(timers, "_pinv"):
        c_pinv = _pinv(c)
    with timed(timers, "_pinv"):
        r_pinv = _pinv(r)
    u = c_pinv @ a @ r_pinv
    return c, u, r, cols, rows


# ---------------------------------------------------------------------------
# cross-shard tournament — the distributed reduction tree
# ---------------------------------------------------------------------------

def _sharded_winners(a_loc: torch.Tensor, group, k: int, nblocks: int):
    """Every rank's local tournament winners: (panels (m, S·k_loc) in rank
    order, their local ids (S, k_loc), the k winners' positions among the
    panels' columns, k_loc)."""
    n_loc = a_loc.shape[1]
    k_loc = min(k, n_loc)
    sel_loc = tournament_select(a_loc, k_loc, nblocks)   # (k_loc,) local ids
    panels = all_gather(a_loc[:, sel_loc], group, dim=1)      # tiled
    sels = all_gather(sel_loc[None], group, dim=0)            # untiled: (S, k_loc)
    return panels, sels, qrcp_select(panels, k), k_loc


def tournament_select_sharded(a_loc: torch.Tensor, group, k: int,
                              nblocks: int = 8) -> torch.Tensor:
    """Tournament pivoting across a column-sharded matrix.

    a_loc: (m, n_loc), this rank's column panel (every rank the same
    n_loc). Returns GLOBAL column indices (k,), the same on every rank
    (columns numbered rank-major: global = rank * n_loc + local).

    One tiled all-gather of every rank's k winner columns (S·k·m values)
    and one untiled all-gather of their local ids, then a replicated final
    round: the JAX package's shape of the tree (reference: utils/
    iterativeKernels/tournamentPivoting.c:41-80 moves the candidates up
    log2(P) levels).
    """
    n_loc = a_loc.shape[1]
    _, sels, win, k_loc = _sharded_winners(a_loc, group, k, nblocks)
    shard = win // k_loc
    return shard * n_loc + sels[shard, win % k_loc]


def tp_qr_sharded(a_loc: torch.Tensor, group, k: int, nblocks: int = 8):
    """Distributed TP-QR of a column-sharded matrix.

    Returns (q, r_loc, cols): q (m, k) the orthonormal basis of the k
    tournament-selected columns (the same on every rank), r_loc = qᵀ a_loc
    (k, n_loc) sharded like the input, cols (k,) global indices.
    (reference: utils/iterativeKernels/tournamentPivotingQR.c)"""
    n_loc = a_loc.shape[1]
    panels, sels, win, k_loc = _sharded_winners(a_loc, group, k, nblocks)
    cols = (win // k_loc) * n_loc + sels[win // k_loc, win % k_loc]
    q, _ = tsqr(panels[:, win], nblocks=nblocks)
    return q, q.mT @ a_loc, cols
