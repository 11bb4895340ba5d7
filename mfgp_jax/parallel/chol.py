"""ICI-distributed blocked Cholesky factorization.

The single remaining replicated O(N^2) object in the training step is the
covariance/Cholesky pair (the gradient's inverse is already column-sharded,
parallel/sharded.py). This module factorizes a column-sharded SPD matrix in
place: chip c owns the contiguous column block [c*Nc, (c+1)*Nc); the
right-looking algorithm walks static panels of width ``block``:

  1. the panel owner factorizes its (b x b) diagonal block and solves the
     sub-diagonal rows (all local work),
  2. the finished panel is broadcast with one ``psum`` (owner contributes,
     others contribute zeros),
  3. every chip applies the trailing update to its own columns with one
     matmul.

Per-chip memory is O(N^2 / n_mp); comms are N/b panel broadcasts of
(N x b) over ICI (= one matrix pass total). The panel loop is a static
Python loop (shapes fixed per step), so XLA sees N/b small jitted stages.

Column layouts: the default 1D block layout gives chip c the contiguous
columns [c*Nc, (c+1)*Nc) — simple, but the trailing update shrinks toward
the last chips, so late panels idle early chips. ``layout="cyclic"``
(block-cyclic) assigns panel p to chip p % n_mp, keeping every chip active
until the final n_mp panels (see ``panel_utilization`` for the measured
balance win). The cyclic path permutes the global column order outside the
shard body, so one sweep kernel serves both layouts.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mfgp_jax.ops import linalg as _la
from mfgp_jax.parallel.mesh import MP_AXIS

_HIGHEST = jax.lax.Precision.HIGHEST


def _owner_and_slot(k, nc, block, n_mp, layout):
    """(owner chip, local column offset) of the panel starting at global
    column k — static Python ints (k is static in the panel loops)."""
    if layout == "block":
        return k // nc, k % nc
    p = k // block  # global panel index
    return p % n_mp, (p // n_mp) * block


def _local_to_global_cols(idx, n, nc, block, n_mp, layout):
    """Global column indices of this chip's nc local columns (traced idx)."""
    j = jnp.arange(nc)
    if layout == "block":
        return idx * nc + j
    return ((j // block) * n_mp + idx) * block + (j % block)


def cyclic_permutation(n: int, n_mp: int, block: int) -> np.ndarray:
    """Global-column permutation gathering each chip's cyclic panels into a
    contiguous shard: perm[c*nc + j] = global column of chip c's local j."""
    cols = []
    npan = n // block
    for c in range(n_mp):
        for p in range(c, npan, n_mp):
            cols.extend(range(p * block, (p + 1) * block))
    return np.asarray(cols, np.int32)


def panel_utilization(n: int, n_mp: int, block: int, layout: str) -> float:
    """Mean trailing-update load balance over the panel sweep.

    For each panel step, each chip updates its local columns with global
    index past the panel; utilization = mean_k (mean_c active_c / max_c
    active_c) over steps with any trailing work. 1.0 = perfectly balanced.
    """
    nc = n // n_mp
    ratios = []
    for k in range(0, n, block):
        active = []
        for c in range(n_mp):
            if layout == "block":
                cols = np.arange(c * nc, (c + 1) * nc)
            else:
                j = np.arange(nc)
                cols = ((j // block) * n_mp + c) * block + (j % block)
            active.append(int(np.sum(cols >= k + block)))
        if max(active):
            ratios.append(np.mean(active) / max(active))
    return float(np.mean(ratios))


def _chol_cols_body(A, idx, n, nc, block, axis, layout="block", n_mp=None):
    """In-shard right-looking Cholesky sweep (see module docstring).

    A: (n, nc) this chip's columns; idx: this chip's mesh index along
    ``axis``. Returns this chip's columns of L (strict upper zeroed).
    Usable inside any shard_map (make_sharded_cholesky wraps it; the fully
    sharded gradient composes it with the solve sweeps)."""
    n_mp = n_mp or (n // nc)
    my_cols = _local_to_global_cols(idx, n, nc, block, n_mp, layout)
    for k in range(0, n, block):
        owner, k_local = _owner_and_slot(k, nc, block, n_mp, layout)
        pan_cols = jax.lax.dynamic_slice(A, (0, k_local), (n, block))
        diag = jax.lax.dynamic_slice(pan_cols, (k, 0), (block, block))
        Lkk = _la.chol(diag)
        sol = jax.scipy.linalg.solve_triangular(
            Lkk, pan_cols.T, lower=True).T
        rows = jnp.arange(n)[:, None]
        panel = jnp.where(rows < k, 0.0,
                          jnp.where(rows < k + block,
                                    jnp.pad(Lkk, ((k, n - k - block),
                                                  (0, 0))),
                                    sol))
        is_owner = (idx == owner)
        panel = jnp.where(is_owner, panel, jnp.zeros_like(panel))
        panel = jax.lax.psum(panel, axis)
        A = jnp.where(
            is_owner,
            jax.lax.dynamic_update_slice(A, panel, (0, k_local)),
            A)
        pj = panel[my_cols]
        upd = jnp.dot(panel, pj.T, precision=_HIGHEST)
        col_active = (my_cols >= k + block)[None, :]
        row_active = (jnp.arange(n) >= k + block)[:, None]
        A = A - jnp.where(col_active & row_active, upd, 0.0)
    tril = jnp.arange(n)[:, None] >= my_cols[None, :]
    return jnp.where(tril, A, 0.0)


def _broadcast_panel(L_cols, idx, k, n, nc, block, axis,
                     layout="block", n_mp=None):
    """psum-broadcast column panel [k, k+block) from its owner chip."""
    owner, k_local = _owner_and_slot(k, nc, block, n_mp or (n // nc),
                                     layout)
    panel = jax.lax.dynamic_slice(L_cols, (0, k_local), (n, block))
    panel = jnp.where(idx == owner, panel, jnp.zeros_like(panel))
    return jax.lax.psum(panel, axis)


def _tri_solve_lower_body(L_cols, B_cols, idx, n, nc, block, axis,
                          layout="block", n_mp=None):
    """Forward substitution ``L X = B`` with L column-sharded (block or
    block-cyclic layout) and the RHS column-sharded (its own column split
    is layout-agnostic: every chip holds full rows of its RHS columns).

    Per row-block step: one psum broadcasts the owner's L panel; each chip
    then solves its own RHS columns locally. X comes back column-sharded
    like B."""
    X = B_cols
    for k in range(0, n, block):
        panel = _broadcast_panel(L_cols, idx, k, n, nc, block, axis,
                                 layout, n_mp)
        Lkk = jax.lax.dynamic_slice(panel, (k, 0), (block, block))
        rhs_k = jax.lax.dynamic_slice(X, (k, 0), (block, X.shape[1]))
        x_k = jax.scipy.linalg.solve_triangular(Lkk, rhs_k, lower=True)
        X = jax.lax.dynamic_update_slice(X, x_k, (k, 0))
        # eliminate this block from the rows below
        below = jnp.dot(panel, x_k, precision=_HIGHEST)  # (n, cols)
        row_mask = (jnp.arange(n) >= k + block)[:, None]
        X = X - jnp.where(row_mask, below, 0.0)
    return X


def _tri_solve_upper_body(L_cols, Y_cols, idx, n, nc, block, axis,
                          layout="block", n_mp=None):
    """Backward substitution ``L^T X = Y`` with column-sharded operands.

    Sweeps row blocks last-to-first; block i needs ``L[j, i]^T X_j`` for
    j > i, which lives entirely in the broadcast panel i."""
    X = Y_cols
    for k in range(n - block, -1, -block):
        panel = _broadcast_panel(L_cols, idx, k, n, nc, block, axis,
                                 layout, n_mp)
        Lkk = jax.lax.dynamic_slice(panel, (k, 0), (block, block))
        rhs_k = jax.lax.dynamic_slice(X, (k, 0), (block, X.shape[1]))
        # subtract sum_{j>k} L[j, k]^T X_j  (rows below k+block of panel)
        row_mask = (jnp.arange(n) >= k + block)[:, None]
        Xbelow = jnp.where(row_mask, X, 0.0)
        corr = jnp.dot(panel.T, Xbelow, precision=_HIGHEST)  # (block, cols)
        x_k = jax.scipy.linalg.solve_triangular(Lkk.T, rhs_k - corr,
                                                lower=False)
        X = jax.lax.dynamic_update_slice(X, x_k, (k, 0))
    return X


def make_sharded_cholesky(mesh: Mesh, n: int, block: int = 256,
                          layout: str = "block"):
    """Build ``f(K) -> L`` for (n, n) SPD inputs, column-sharded over mp.

    ``n`` must be divisible by ``n_mp * block`` (static panel layout).
    The returned function accepts a replicated or sharded K and returns L
    with the same sharding semantics as its input partitioning under jit
    (callers keep it sharded by passing a sharded K).

    ``layout="cyclic"`` uses the block-cyclic column assignment (panel p ->
    chip p % n_mp): the trailing-update work stays balanced across chips
    through the whole sweep (panel_utilization measures the win). The
    global column order is permuted into cyclic shards on the way in and
    restored on the way out, so the caller-facing contract is identical.
    """
    if layout not in ("block", "cyclic"):
        raise ValueError(layout)
    n_mp = mesh.shape[MP_AXIS]
    if n % n_mp:
        raise ValueError(f"n={n} not divisible by mp={n_mp}")
    nc = n // n_mp
    if nc % block:
        raise ValueError(f"column block {nc} not divisible by panel {block}")

    def shard_body(K_cols):
        idx = jax.lax.axis_index(MP_AXIS)
        return _chol_cols_body(K_cols, idx, n, nc, block, MP_AXIS,
                               layout=layout, n_mp=n_mp)

    smapped = jax.shard_map(shard_body, mesh=mesh,
                            in_specs=P(None, MP_AXIS),
                            out_specs=P(None, MP_AXIS))
    if layout == "block":
        return jax.jit(smapped)

    perm = jnp.asarray(cyclic_permutation(n, n_mp, block))
    inv = jnp.asarray(np.argsort(cyclic_permutation(n, n_mp, block)))

    def cyclic_fn(K):
        return smapped(K[:, perm])[:, inv]

    return jax.jit(cyclic_fn)


def make_sharded_tri_solves(mesh: Mesh, n: int, ncols: int,
                            block: int = 256):
    """Build ``(lower_fn, upper_fn)`` for column-sharded triangular solves.

    Both L and the RHS/solution are column-sharded over mp; each sweep step
    is one (n, block) psum broadcast + local block solve + local matmul
    elimination. ``ncols`` is the global RHS column count (must divide by
    the mp extent)."""
    n_mp = mesh.shape[MP_AXIS]
    if n % (n_mp) or (n // n_mp) % block:
        raise ValueError(f"n={n} incompatible with mp={n_mp}, block={block}")
    if ncols % n_mp:
        raise ValueError(f"ncols={ncols} not divisible by mp={n_mp}")
    nc = n // n_mp

    def lower_body(L_cols, B_cols):
        idx = jax.lax.axis_index(MP_AXIS)
        return _tri_solve_lower_body(L_cols, B_cols, idx, n, nc, block,
                                     MP_AXIS)

    def upper_body(L_cols, Y_cols):
        idx = jax.lax.axis_index(MP_AXIS)
        return _tri_solve_upper_body(L_cols, Y_cols, idx, n, nc, block,
                                     MP_AXIS)

    specs = dict(mesh=mesh, in_specs=(P(None, MP_AXIS), P(None, MP_AXIS)),
                 out_specs=P(None, MP_AXIS))
    return (jax.jit(jax.shard_map(lower_body, **specs)),
            jax.jit(jax.shard_map(upper_body, **specs)))


def make_fully_sharded_nlml_value_and_grad(mesh: Mesh, n: int,
                                           block: int = 256,
                                           jitter: float = 0.0,
                                           layout: str = "block"):
    """End-to-end memory-scaled MFGP NLML value+gradient (RBF, rhos fixed).

    Every O(N^2) object — the covariance columns, the Cholesky factor, and
    the explicit inverse — lives column-sharded over the mp axis; the only
    replicated arrays are the O(N) data and O(1) parameters:

      1. each chip assembles ITS columns of K_n (local matmul work),
      2. distributed Cholesky (_chol_cols_body),
      3. alpha and logdet from sharded pieces: two distributed triangular
         solves give this chip's K_n^-1 columns; ``alpha = psum(Kinv_c y_c)``
         and ``logdet = psum(local log-diags)``,
      4. the trace-identity contractions of
         models/mfgp.nlml_value_and_grad, psum'd (as in
         make_sharded_nlml_value_and_grad, but without a replicated L).

    Per-chip memory: 3 * N^2/n_mp + O(N); the factorizable N scales
    linearly with the mesh. Returns ``f(params, X, fid, y)``.

    ``layout="cyclic"`` assigns L's panels block-cyclically (panel p ->
    chip p % n_mp), keeping every chip's trailing-update and panel work
    balanced through the whole sweep (``panel_utilization``: 0.51 -> 0.76
    at n/block=32, mp=8). Since each chip ASSEMBLES its own (cyclic)
    columns directly, there is no permutation pass — the layout only
    changes which global columns a chip owns; value/grad outputs are
    layout-invariant (machine-precision parity tested).
    """
    from mfgp_jax.models.mfgp import MFGPParams

    if layout not in ("block", "cyclic"):
        raise ValueError(layout)
    n_mp = mesh.shape[MP_AXIS]
    if n % n_mp or (n // n_mp) % block:
        raise ValueError(f"n={n} incompatible with mp={n_mp}, block={block}")
    nc = n // n_mp

    def shard_body(params, X, fid, y):
        idx = jax.lax.axis_index(MP_AXIS)
        cols = _local_to_global_cols(idx, n, nc, block, n_mp, layout)
        F = params.variances.shape[0]
        D = X.shape[1]

        from mfgp_jax.ops import kernels as _k

        Xc = X[cols]
        fc = fid[cols]
        Wfid = _k.ar1_fidelity_weights(params.rhos, F)
        w_full = Wfid[:, fid]
        w_cols = Wfid[:, fc]

        # 1. local covariance columns + noise on the diagonal entries
        K_cols = jnp.zeros((n, nc), X.dtype)
        Km_cols_list = []
        for m in range(F):
            Km = _k.KERNELS["rbf"](X, Xc, 1.0, params.lengthscales[m])
            Km_cols_list.append(Km)
            K_cols = K_cols + (params.variances[m]
                               * (w_full[m][:, None] * w_cols[m][None, :])
                               * Km)
        noise_c = _k.mf_noise_diag(fc, params.noises) + jitter
        diag_sel = (jnp.arange(n)[:, None] == cols[None, :])
        K_cols = K_cols + jnp.where(diag_sel, noise_c[None, :], 0.0)

        # 2. distributed Cholesky
        L_cols = _chol_cols_body(K_cols, idx, n, nc, block, MP_AXIS,
                                 layout=layout, n_mp=n_mp)

        # 3. sharded inverse columns, alpha, logdet
        eye_cols = diag_sel.astype(X.dtype)
        Yc = _tri_solve_lower_body(L_cols, eye_cols, idx, n, nc, block,
                                   MP_AXIS, layout=layout, n_mp=n_mp)
        Kinv_cols = _tri_solve_upper_body(L_cols, Yc, idx, n, nc, block,
                                          MP_AXIS, layout=layout,
                                          n_mp=n_mp)
        alpha = jax.lax.psum(
            jnp.dot(Kinv_cols, y[cols], precision=_HIGHEST), MP_AXIS)
        logdiag = jnp.log(L_cols[cols, jnp.arange(nc)])
        logdet = 2.0 * jax.lax.psum(jnp.sum(logdiag), MP_AXIS)
        val = (0.5 * jnp.dot(y, alpha) + 0.5 * logdet
               + 0.5 * n * jnp.log(2 * jnp.pi).astype(X.dtype))

        # 4. trace-identity contractions on the sharded columns
        Wm_cols = Kinv_cols - alpha[:, None] * alpha[cols][None, :]
        ones_xc = jnp.concatenate([jnp.ones((nc, 1), X.dtype), Xc], axis=1)
        g_var, g_ls = [], []
        for m in range(F):
            T = (params.variances[m]
                 * (w_full[m][:, None] * w_cols[m][None, :])
                 * Km_cols_list[m])
            A = Wm_cols * T
            sv = jax.lax.psum(
                jnp.dot(A, ones_xc, precision=_HIGHEST), MP_AXIS)
            s, Ax = sv[:, 0], sv[:, 1:]
            g_var.append(0.5 * jnp.sum(s))
            g_ls.append((jnp.sum((X**2) * s[:, None], axis=0)
                         - jnp.sum(X * Ax, axis=0))
                        / (params.lengthscales[m] ** 2))
        diag_w = Wm_cols[cols, jnp.arange(nc)]
        g_noise = jnp.stack([
            0.5 * params.noises[f] * jax.lax.psum(
                jnp.sum(jnp.where(fc == f, diag_w, 0.0)), MP_AXIS)
            for f in range(F)])
        grad = MFGPParams(jnp.stack(g_var), jnp.stack(g_ls),
                          jnp.zeros_like(params.rhos), g_noise)
        return val, grad

    smapped = jax.shard_map(shard_body, mesh=mesh,
                            in_specs=(P(), P(), P(), P()),
                            out_specs=(P(), P()))
    return jax.jit(smapped)


def fit_memory_scaled(mesh: Mesh, X, fid, y, *, steps: int = 100,
                      learning_rate: float = 0.05, block: int = 256,
                      jitter: float = 1e-6, params0=None):
    """Adam fit of one MFGP whose per-step gradient is fully ICI-sharded.

    For N beyond a single device's memory (every N^2 object is O(N^2/n_mp) per
    chip, see make_fully_sharded_nlml_value_and_grad). Parameters are O(1)
    and update host-side with optax. Returns (params, loss_history).
    """
    import jax.numpy as jnp
    import numpy as np
    import optax

    from mfgp_jax.models.mfgp import MFGPParams

    X = jnp.asarray(X, jnp.float32)
    fid = jnp.asarray(fid, jnp.int32)
    y = jnp.asarray(y, jnp.float32)
    N, D = X.shape
    F = int(np.asarray(fid).max()) + 1
    params = params0 or MFGPParams.default(F, D, jnp.float32)
    vg = make_fully_sharded_nlml_value_and_grad(mesh, N, block=block,
                                                jitter=jitter)
    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)
    history = []
    for _ in range(steps):
        val, grad = vg(params, X, fid, y)
        grad = jax.tree.map(jnp.nan_to_num, grad)
        updates, opt_state = opt.update(grad, opt_state, params)
        params = optax.apply_updates(params, updates)
        history.append(float(val))
    return params, history
