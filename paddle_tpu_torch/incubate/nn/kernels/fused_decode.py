"""Fused single-launch b1 decode step (port of
``paddle_tpu/incubate/nn/kernels/fused_decode.py``).

:func:`fused_decode_layers` runs the whole weight-only int8 layer stack
of a GPT decode step for ONE token: per layer LN -> int8 qkv -> attention
over the flat ``[L, T, H]`` cache with this token's K/V row written in
place -> proj -> LN -> fc1 + tanh-GELU -> fc2, each with its residual.
The TPU kernel ``_decode_kernel`` walks the layers as a sequential grid
and carries ``h`` in VMEM; its CUDA counterpart in
``csrc/fused_decode.cu`` is ONE cooperative launch (one block an SM)
whose blocks walk the layers together, six grid barriers a layer: each
block streams its own fixed share of every GEMV's int8 weights through
a ring in shared memory that stays full across the barriers, the last
block to finish a column tile applies its epilogue, and attention runs
as (head, row tile) items over the whole grid (the source note says
how, and what bounds it).  The plan functions below
(:func:`gemv_parts`, :func:`attention_plan`, :func:`scratch_layout`, ...)
mirror the kernel's own, so the CPU tests can check them.

Dispatch: a CPU tensor runs :func:`fused_decode_layers_plain`; a CUDA
tensor launches the kernel or raises.  There is no fallback from one to
the other.

Only row 0 of the ``[8, H]`` hidden state is real (the TPU layout pads
the batch of one to 8 sublanes).  Both versions compute row 0 only and
return rows 1-7 as zeros.

The rounding points are the TPU kernel's, and both versions keep them:
GEMV inputs rounded to bfloat16 against the exact int8 weight with a
float32 sum, then ``* scale + bias``; history attention on bfloat16 q
(scaled in float32 first), bfloat16 K/V rows (int8 dequantized in
float32 first; a float32 cache is rounded too) and bfloat16 p, over
256-row chunks of online softmax; the NEW token attended unrounded
(int8: ``q * scale`` of its stored bytes, fp8: the stored value, model
dtype: the float32 row the cache stores rounded); the GELU output
rounded to bfloat16 before fc2.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..kv_quant import byte_view, quantize_kv
from . import _build
from .flash_decode import kv_mode

__all__ = ["fused_decode_layers", "fused_decode_layers_plain", "KV_CHUNK",
           "MAX_WIDTH", "SUPPORTED_HEAD_DIMS", "LAUNCHES", "MODE_LAUNCHES",
           "reset_launches", "GEMV_TILE", "MIN_TILE_ROWS", "gemv_plan",
           "gemv_parts", "attention_plan", "attention_items",
           "scratch_layout", "sync_ints", "barriers_per_token",
           "kernel_plan", "last_barriers"]

#: rows of one online-softmax chunk of the history (the TPU kernel's
#: KV streaming chunk; p is rounded against each chunk's running max)
KV_CHUNK = 256
#: largest hidden and FFN width the kernel takes (its GEMV input vector
#: lives in shared memory)
MAX_WIDTH = 16384
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_NEG_INF = -1e30
_GELU_C = math.sqrt(2 / math.pi)

#: kernel launches so far (CUDA tensors only; the plain version and
#: rejected calls do not count) ...
LAUNCHES = 0
#: ... and by K/V storage mode ("dense" = the model dtype, "int8", "fp8")
MODE_LAUNCHES = {"dense": 0, "int8": 0, "fp8": 0}

_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}
_SMALL = ("qkv_b", "proj_b", "fc1_b", "fc2_b", "ln1_g", "ln1_b", "ln2_g",
          "ln2_b")
_fns = None
_PLANS = {}
_SYNC = {}
_LAST_SYNC = []


# ---------------------------------------------------------------------------
# the kernel's plan, mirrored (csrc/fused_decode.cu: gemv_plan,
# smem_setup, layout, attn_plan)
# ---------------------------------------------------------------------------

#: int8 columns of a GEMV column tile (the bytes of one weight row that
#: a ring stage holds)
GEMV_TILE = 512
#: fewest history rows of an attention item
MIN_TILE_ROWS = 16
_SYNC_TILE_COUNTERS = 4        # sync slots before the tile counters
_BARRIERS_DONE = 2             # sync slot: barriers of the last launch


def _ceil(a, b):
    return -(-a // b)


def _gemvs(H, F):
    """(K, N) of qkv, proj, fc1 and fc2."""
    return ((H, 3 * H), (H, H), (H, F), (F, H))


def gemv_plan(K, N, grid):
    """(column tiles, parts a tile) of a [K, N] GEMV on ``grid`` blocks:
    tiles of GEMV_TILE int8 columns; with no more tiles than blocks,
    each tile's K rows are cut into ``grid // tiles`` parts (at most K //
    16: 16 rows or more a part), one a block, else every block takes
    whole tiles."""
    tiles = _ceil(N, GEMV_TILE)
    m = grid // tiles if tiles <= grid else 1
    return tiles, max(1, min(m, K // 16))


def gemv_parts(K, N, grid):
    """{tile: [(block, part, k0, k1)]} of a [K, N] GEMV: the K rows
    ``k0:k1`` of each tile that each block sums, in part order (the order
    the kernel adds the parts in).  Block b takes part b % m of tile
    b // m (blocks from tiles * m on idle), or, with more tiles than
    blocks, the whole tiles b, b + grid, ..."""
    tiles, m = gemv_plan(K, N, grid)
    out = {}
    for b in range(grid):
        if tiles <= grid:
            if b < tiles * m:
                t, j = divmod(b, m)
                out.setdefault(t, []).append((b, j, K * j // m,
                                              K * (j + 1) // m))
        else:
            for t in range(b, tiles, grid):
                out.setdefault(t, []).append((b, 0, 0, K))
    return out


def attention_plan(pos, num_heads, grid):
    """(rows of a tile, tiles of each head) of the attention items at
    ``pos``: the shortest tile (a power of 2 from MIN_TILE_ROWS to
    KV_CHUNK) whose ``num_heads * tiles`` items fit the grid."""
    tr = MIN_TILE_ROWS
    while tr < KV_CHUNK and num_heads * _ceil(pos, tr) > grid:
        tr *= 2
    return tr, _ceil(pos, tr)


def attention_items(pos, num_heads, grid):
    """[(block, head, tile, first row, end row)] of the attention items
    at ``pos``, in the order the blocks take them (item i = tile i //
    num_heads of head i % num_heads, on block i % grid): every history
    row < pos of every head in exactly one item."""
    tr, nt = attention_plan(pos, num_heads, grid)
    return [(i % grid, i % num_heads, i // num_heads,
             (i // num_heads) * tr, min(pos, (i // num_heads + 1) * tr))
            for i in range(num_heads * nt)]


def scratch_layout(H, F, T, num_heads, grid):
    """{region: (offset, size)} of the kernel's float32 scratch and
    "total": the layer carries h and h2, q/k/v, the GELU output, the new
    V rows and scores, the history scores [nH, T], the tile maxima and
    sums of p and the tiles' P.V [nH, tiles, hD] (tiles = T /
    MIN_TILE_ROWS at most), and the GEMV parts [tile, part, GEMV_TILE]
    of the GEMV with the most."""
    mt = _ceil(T, MIN_TILE_ROWS)
    parts = max(t * m for t, m in (gemv_plan(K, N, grid)
                                   for K, N in _gemvs(H, F)))
    sizes = (("hA", H), ("hB", H), ("qkv", 3 * H), ("g", F), ("vn", H),
             ("sn", num_heads), ("s", num_heads * T),
             ("tm", num_heads * mt), ("ls", num_heads * mt),
             ("acc", mt * H))
    out, off = {}, 0
    for name, n in sizes:
        out[name] = (off, n)
        off += _ceil(n, 4) * 4
    out["part"] = (off, parts * GEMV_TILE)
    out["total"] = off + parts * GEMV_TILE
    return out


def sync_ints(H, F):
    """int32 slots of the sync buffer: the grid barrier's 64-bit arrival
    count, the barriers of the last launch, a spare slot, then one
    counter per column tile."""
    return _SYNC_TILE_COUNTERS + max(_ceil(3 * H, GEMV_TILE),
                                     _ceil(F, GEMV_TILE))


def barriers_per_token(num_layers):
    """Grid barriers of one launch: six a layer (after qkv, the scores,
    P.V, proj and fc1; after fc2 but for the last layer)."""
    return 6 * num_layers - 1


def reset_launches():
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for mode in MODE_LAUNCHES:
        MODE_LAUNCHES[mode] = 0


def _check(h0, qlayers, cache_k, cache_v, num_heads, scales):
    """The JAX function's input checks (T % 8, T % KV_CHUNK above it,
    H3 == 3H, the scale planes' shapes) plus the dtypes, shapes and
    widths both versions take.  Returns (weights {name: (q, s)}, small
    params {name: [L, N]}, L, H, F, nH, T)."""
    T = cache_k.shape[1]
    if T % 8:
        raise ValueError(
            f"cache length {T} must be a multiple of 8 (the TPU kernel's "
            "aligned new-row group; the layout contract of both ports)")
    if T > KV_CHUNK and T % KV_CHUNK:
        raise ValueError(
            f"cache length {T} must be a multiple of {KV_CHUNK} (the KV "
            "streaming chunk) — a ragged tail would be silently dropped "
            "from attention")
    w = {}
    for name in ("qkv_w", "proj_w", "fc1_w", "fc2_w"):
        pair = qlayers[name]
        if not (isinstance(pair, tuple) and len(pair) == 2):
            raise ValueError(f"qlayers[{name!r}] must be an int8 (weight, "
                             "scale) pair (gpt.quantize_decode_params)")
        q, s = pair
        if q.dtype != torch.int8 or s.dtype != torch.float32:
            raise TypeError(f"{name}: weight must be int8 and scale "
                            f"float32, got {q.dtype} / {s.dtype}")
        if q.dim() != 3 or s.dim() != 2 or tuple(s.shape) != (
                q.shape[0], q.shape[2]):
            raise ValueError(f"{name}: weight [L, K, N] and scale [L, N] "
                             f"expected, got {tuple(q.shape)} / "
                             f"{tuple(s.shape)}")
        w[name] = (q, s)
    L, H, H3 = w["qkv_w"][0].shape
    F = w["fc1_w"][0].shape[-1]
    if H3 != 3 * H:
        raise ValueError(
            f"qkv weight last dim {H3} must be exactly 3*H (H={H}): a "
            "ragged qkv would silently misalign the q/k/v slices")
    for name, shape in (("proj_w", (L, H, H)), ("fc1_w", (L, H, F)),
                        ("fc2_w", (L, F, H))):
        if tuple(w[name][0].shape) != shape:
            raise ValueError(f"{name}: weight {tuple(w[name][0].shape)}, "
                             f"want {shape}")
    nH = int(num_heads)
    if nH < 1 or H % nH or H // nH not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{nH} heads over H={H}: the head dim must be "
                         f"one of {SUPPORTED_HEAD_DIMS}")
    if H % 16 or F % 16 or max(H, F) > MAX_WIDTH:
        raise ValueError(f"H={H} and F={F} must be multiples of 16 and at "
                         f"most {MAX_WIDTH}")
    small = {}
    widths = {"qkv_b": 3 * H, "fc1_b": F}
    for name in _SMALL:
        t = qlayers[name]
        n = widths.get(name, H)
        if t.numel() != L * n or t.shape[0] != L:
            raise ValueError(f"{name}: {tuple(t.shape)} does not hold "
                             f"[{L}, {n}]")
        small[name] = t.reshape(L, n)
    if len({t.dtype for t in small.values()}) != 1 or \
            small["ln1_g"].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("biases and LN params must share one dtype, "
                        "float32 or bfloat16")
    if h0.dtype != torch.float32 or tuple(h0.shape) != (8, H):
        raise TypeError(f"h0 must be float32 [8, {H}], got {h0.dtype} "
                        f"{tuple(h0.shape)}")
    if cache_k.dtype not in _KV_CODE or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"cache must be float32, bfloat16, int8 or "
                        f"float8_e4m3fn, K and V alike; got "
                        f"{cache_k.dtype} / {cache_v.dtype}")
    if tuple(cache_k.shape) != (L, T, H) or cache_v.shape != cache_k.shape:
        raise ValueError(f"caches must be [L, T, H]=({L}, {T}, {H}), got "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)}")
    if (cache_k.dtype == torch.int8) != (scales is not None):
        raise TypeError("an int8 cache takes scales=(ks, vs), and only an "
                        "int8 cache carries scales")
    tensors = [h0, cache_k, cache_v, *small.values()]
    for q, s in w.values():
        tensors += [q, s]
    if scales is not None:
        ks, vs = scales
        if tuple(ks.shape) != (L, T, nH) or tuple(vs.shape) != (L, T, nH):
            raise ValueError(
                f"KV scale planes must be [L, T, nH]=({L}, {T}, {nH}), "
                f"got {tuple(ks.shape)} / {tuple(vs.shape)}")
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError("KV scale planes must be float32")
        tensors += [ks, vs]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands lie on different devices: "
                         f"{sorted(map(str, devs))}")
    return w, small, L, H, F, nH, T


def _bf(x):
    return x.to(torch.bfloat16).float()


def _layer_norm(x, g, b, eps):
    mu = x.mean()
    var = ((x - mu) * (x - mu)).mean()
    return (x - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _gelu(x):
    """jax.nn.gelu(approximate=True), operation for operation."""
    cdf = 0.5 * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x))))
    return x * cdf


def _dequant_matvec(x, pair):
    """bfloat16(x) @ int8 weight in float32, then the per-channel
    scale."""
    q, s = pair
    return (_bf(x) @ q.float()) * s


def _store_row(cache, l, pos, x, mode):
    """Write this token's row ``x`` [nH, hD] float32 into ``cache[l,
    pos]`` in its storage and return (the value the new token attends,
    its int8 scale or None)."""
    if mode == "int8":
        q, s = quantize_kv(x, "int8")
        cache[l, pos] = q.reshape(-1)
        return q.float() * s, s.reshape(-1)
    if mode == "fp8":
        stored, _ = quantize_kv(x, "fp8")
        byte_view(cache)[l, pos] = byte_view(stored).reshape(-1)
        return stored.float(), None
    cache[l, pos] = x.reshape(-1).to(cache.dtype)
    return x, None


def _history(cache, scale, l, a, b, nH, hD):
    """Rows [a, b) of layer l as the kernel reads them: dequantized in
    float32, then rounded to bfloat16."""
    rows = cache[l, a:b].float().view(b - a, nH, hD)
    if scale is not None:
        rows = rows * scale[l, a:b][..., None]
    return _bf(rows)


def _attention(q, kn, vn, cache_k, cache_v, ks, vs, l, pos, nH, hD):
    """One token's attention for layer l: the history rows < pos in
    KV_CHUNK-row chunks of online softmax, then the new token."""
    qs = q.view(nH, hD) * (1.0 / hD ** 0.5)
    qb = _bf(qs)
    m = torch.full((nH,), _NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((nH,), dtype=torch.float32, device=q.device)
    acc = torch.zeros((nH, hD), dtype=torch.float32, device=q.device)
    for a in range(0, pos, KV_CHUNK):
        b = min(pos, a + KV_CHUNK)
        kt = _history(cache_k, ks, l, a, b, nH, hD)
        vt = _history(cache_v, vs, l, a, b, nH, hD)
        s = torch.einsum("hd,thd->ht", qb, kt)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[:, None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[:, None] + torch.einsum("ht,thd->hd", _bf(p), vt)
        m = m_new
    s_n = (qs * kn).sum(-1)
    m_new = torch.maximum(m, s_n)
    p_n = torch.exp(s_n - m_new)
    corr = torch.exp(m - m_new)
    lsum = lsum * corr + p_n
    acc = acc * corr[:, None] + p_n[:, None] * vn
    return (acc / lsum[:, None]).reshape(-1)


def fused_decode_layers_plain(h0, qlayers, cache_k, cache_v, pos, num_heads,
                              *, eps: float = 1e-5, scales=None):
    """The kernel's function in plain PyTorch, on row 0, with the
    kernel's rounding points (module docstring).  Same arguments and
    results as :func:`fused_decode_layers`; ``pos`` an int or a
    one-element integer tensor.  The wrapper runs it for CPU tensors;
    it computes on whatever device its operands lie on."""
    checked = _check(h0, qlayers, cache_k, cache_v, num_heads, scales)
    return _plain(h0, cache_k, cache_v, scales, pos, eps, *checked)


def _plain(h0, cache_k, cache_v, scales, pos, eps, w, small, L, H, F, nH,
           T):
    """The body of :func:`fused_decode_layers_plain` on operands that
    ``_check`` has passed (its results are the last seven arguments)."""
    pos = int(pos)
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache [0, {T})")
    mode = kv_mode(cache_k)
    ks, vs = scales if scales is not None else (None, None)
    hD = H // nH
    h = h0[0].float()
    for l in range(L):
        x = _layer_norm(h, small["ln1_g"][l], small["ln1_b"][l], eps)
        qkv = _dequant_matvec(x, (w["qkv_w"][0][l], w["qkv_w"][1][l])) \
            + small["qkv_b"][l].float()
        q, k, v = (qkv[i * H:(i + 1) * H].view(nH, hD) for i in range(3))
        kn, k_sc = _store_row(cache_k, l, pos, k, mode)
        vn, v_sc = _store_row(cache_v, l, pos, v, mode)
        if k_sc is not None:
            ks[l, pos] = k_sc
            vs[l, pos] = v_sc
        attn = _attention(q, kn, vn, cache_k, cache_v, ks, vs, l, pos, nH,
                          hD)
        h = h + _dequant_matvec(attn, (w["proj_w"][0][l],
                                       w["proj_w"][1][l])) \
            + small["proj_b"][l].float()
        x = _layer_norm(h, small["ln2_g"][l], small["ln2_b"][l], eps)
        g = _gelu(_dequant_matvec(x, (w["fc1_w"][0][l], w["fc1_w"][1][l]))
                  + small["fc1_b"][l].float())
        h = h + _dequant_matvec(g, (w["fc2_w"][0][l], w["fc2_w"][1][l])) \
            + small["fc2_b"][l].float()
    out = torch.zeros((8, H), dtype=torch.float32, device=h0.device)
    out[0] = h
    return (out, cache_k, cache_v) + (tuple(scales) if scales else ())


def _lib():
    global _fns
    if _fns is None:
        lib = _build.load("fused_decode")
        plan = lib.pt_fused_decode_plan
        plan.argtypes = [ctypes.c_int, ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 4
        plan.restype = ctypes.c_int
        scratch = lib.pt_fused_decode_scratch
        scratch.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        scratch.restype = ctypes.c_int
        fn = lib.pt_fused_decode
        fn.argtypes = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns = (fn, plan, scratch)
    return _fns


def kernel_plan(device, H, F, T, num_heads):
    """The launch on this device at these shapes: {grid, threads (a
    block), stages (of the weight ring), smem (dynamic bytes a block),
    scratch_floats, sync_ints, tile}, from the kernel's own plan
    functions (the CUDA occupancy calculator, once per shape)."""
    key = (device.index, H, F)
    _, plan, scratch = _lib()
    if key not in _PLANS:
        out = [ctypes.c_int() for _ in range(4)]
        rc = plan(H, F, *(ctypes.byref(x) for x in out))
        if rc != 0:
            raise RuntimeError(f"fused_decode launch plan failed: CUDA "
                               f"error {rc}")
        _PLANS[key] = dict(zip(("grid", "threads", "stages", "smem"),
                               (x.value for x in out)))
    got = dict(_PLANS[key])
    n, ints, tile = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    rc = scratch(H, F, T, num_heads, got["grid"], ctypes.byref(n),
                 ctypes.byref(ints), ctypes.byref(tile))
    if rc != 0:
        raise RuntimeError(f"fused_decode scratch plan failed: CUDA error "
                           f"{rc}")
    got.update(scratch_floats=n.value, sync_ints=ints.value, tile=tile.value)
    return got


def _sync(device, H, F, n):
    """The zeroed int32 buffer of the barrier and tile counters for
    launches on this device at these widths (every launch leaves its
    counters at 0)."""
    key = (device.index, H, F)
    if key not in _SYNC:
        _SYNC[key] = torch.zeros((n,), dtype=torch.int32, device=device)
    return _SYNC[key]


def last_barriers():
    """Grid barriers the most recent launch went through, as the kernel
    counted them (reads the card: a host sync); None before any
    launch."""
    if not _LAST_SYNC:
        return None
    return int(_LAST_SYNC[0][_BARRIERS_DONE].item())


def _launch(h0, cache_k, cache_v, scales, pos, eps, w, small, L, H, F, nH,
            T):
    global LAUNCHES
    tensors = [h0, cache_k, cache_v, *small.values()]
    for q, s in w.values():
        tensors += [q, s]
    if scales is not None:
        tensors += list(scales)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_decode_layers takes contiguous operands on "
                         "the card")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_decode_layers takes 16-byte aligned "
                         "operands on the card (its rows are read in "
                         "16-byte vectors)")
    if torch.is_tensor(pos):
        if pos.dtype != torch.int32 or pos.numel() != 1 or \
                pos.device != h0.device:
            raise ValueError(f"pos must be one int32 value on {h0.device}, "
                             f"got {pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
    else:
        pos = torch.tensor([int(pos)], dtype=torch.int32, device=h0.device)
    mode = kv_mode(cache_k)
    ks, vs = scales if scales is not None else (None, None)
    with torch.cuda.device(h0.device):
        plan = kernel_plan(h0.device, H, F, T, nH)
        fn = _lib()[0]
        out = torch.empty((8, H), dtype=torch.float32, device=h0.device)
        scratch = torch.empty((plan["scratch_floats"],), dtype=torch.float32,
                              device=h0.device)
        sync = _sync(h0.device, H, F, plan["sync_ints"])
        stream = torch.cuda.current_stream(h0.device).cuda_stream
        rc = fn(h0.data_ptr(),
                *(w[n][0].data_ptr() for n in ("qkv_w", "proj_w", "fc1_w",
                                               "fc2_w")),
                *(w[n][1].data_ptr() for n in ("qkv_w", "proj_w", "fc1_w",
                                               "fc2_w")),
                *(small[n].data_ptr() for n in _SMALL),
                cache_k.data_ptr(), cache_v.data_ptr(),
                None if ks is None else ks.data_ptr(),
                None if vs is None else vs.data_ptr(),
                pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                sync.data_ptr(), L, H, F, nH, T,
                int(small["ln1_g"].dtype == torch.bfloat16),
                _KV_CODE[cache_k.dtype], eps, 1.0 / (H // nH) ** 0.5,
                plan["grid"], plan["stages"], plan["scratch_floats"],
                plan["sync_ints"], stream)
    if rc != 0:
        raise RuntimeError(f"fused_decode kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    _LAST_SYNC[:] = [sync]
    return (out, cache_k, cache_v) + (tuple(scales) if scales else ())


def fused_decode_layers(h0, qlayers, cache_k, cache_v, pos, num_heads,
                        *, eps: float = 1e-5, scales=None):
    """The whole int8 layer stack for ONE token.

    h0 [8, H] float32 (row 0 real); qlayers the stacked int8 layer tree
    of ``gpt.quantize_decode_params`` ((int8, float32 scale) pairs for
    qkv [L, H, 3H], proj, fc1, fc2; biases and LN params in float32 or
    bfloat16); cache_k/cache_v [L, T, H] in float32 or bfloat16 (the
    model-dtype mode), float8_e4m3fn, or int8 with ``scales=(ks, vs)``
    float32 [L, T, nH]; pos the position fed (rows < pos are the
    history, the new K/V lands at row pos): an int, or an int32 tensor
    of one element that the kernel reads on the device.  Returns (h_out
    [8, H] float32 — row 0 real, rows 1-7 zero — cache_k, cache_v) or,
    with scales, (h_out, cache_k, cache_v, ks, vs); the caches are
    updated IN PLACE (the JAX version aliases them).

    CPU tensors run :func:`fused_decode_layers_plain`; CUDA tensors
    launch the kernel (operands contiguous and 16-byte aligned) or
    raise.  On the card a pos outside [0, T) writes nothing and returns
    NaN in row 0 (reading it would cost a host sync); the plain version
    raises."""
    checked = _check(h0, qlayers, cache_k, cache_v, num_heads, scales)
    if h0.device.type == "cpu":
        return _plain(h0, cache_k, cache_v, scales, pos, eps, *checked)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_decode_layers runs on cuda or cpu tensors, "
                         f"got {h0.device}")
    return _launch(h0, cache_k, cache_v, scales, pos, eps, *checked)
