"""Multi-slot flash-decoding attention (port of
``paddle_tpu/incubate/nn/kernels/flash_decode.py``).

One kernel serves every attention of the serving path: decode (W = 1),
and admission prefill (W = S, pos = 0: causal self-attention is the
window mask with a zero base offset), over two layouts —
:func:`flash_decode_attention` reads a contiguous cache
``[B, T, nKV, hD]``, :func:`flash_decode_paged` a shared page pool
``[num_blocks, block_size, nKV, hD]`` through per-slot block tables —
and three storage modes: the model dtype, int8 ``(data, scale)`` tuples
and bare ``float8_e4m3fn`` tensors.  The TPU kernel
``_flash_decode_kernel`` becomes the hand-written CUDA kernel in
``csrc/flash_decode.cu``; its source note says what bounds it on the
H100 and what the simple design leaves for later.

Dispatch: a CPU tensor runs the plain version
(:func:`flash_decode_attention_plain`, :func:`flash_decode_paged_plain`);
a CUDA tensor launches the kernel or raises.  There is no fallback from
one to the other.

The kernel takes the slot (or page), row and head strides of q, K, V
and the int8 scales, so the prefill path's q/k/v (strided slices of the
packed qkv activation) reach it without a copy; only the last axis of
q, K and V must be contiguous.

On the card a call runs one of three instances (:func:`kernel_instance`,
from shapes and dtypes, never from ``pos``): split-KV on the CUDA cores
for small windows (decode, verify), the tensor cores for bf16 prefill
windows, and the query-tile kernel for the rest.  The split plan
(:func:`decode_plan`) depends on (B, nKV, T) and the card's SM count
only, so the decode step reads ``pos`` on the device alone and the
paged and contiguous layouts run the same plan.  Several splits leave
float32 partials that a second kernel merges in a fixed order
(:func:`flash_decode_split_plain` is that rule in plain PyTorch, for
the tests).  The counts below add one per wrapper call, however many
CUDA launches the call makes.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..kv_quant import byte_view, dequantize_kv, kv_components, kv_map
from . import _build

__all__ = ["flash_decode_attention", "flash_decode_paged",
           "flash_decode_attention_plain", "flash_decode_paged_plain",
           "flash_decode_split_plain", "kernel_instance", "decode_plan",
           "kernel_plan", "kv_mode", "reset_launches", "LAUNCHES",
           "PAGED_LAUNCHES", "MODE_LAUNCHES", "INSTANCE_LAUNCHES"]

#: kernel launches so far (CUDA tensors only; the plain versions and
#: rejected calls do not count): contiguous-layout launches ...
LAUNCHES = 0
#: ... paged-layout launches ...
PAGED_LAUNCHES = 0
#: ... and every launch of either layout by K/V storage mode
#: ("dense" = the model dtype, "int8", "fp8")
MODE_LAUNCHES = {"dense": 0, "int8": 0, "fp8": 0}
#: ... and by instance ("split", "tc", "simt": see kernel_instance)
INSTANCE_LAUNCHES = {"split": 0, "tc": 0, "simt": 0}

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.int8: 2, torch.float8_e4m3fn: 3}
_NEG_INF = -1e30
_INSTANCE_CODE = {"simt": 0, "split": 1, "tc": 2}
#: KV rows a stage of the split-KV kernel; a split is a whole number
SPLIT_ROWS = 32
#: queries (nH/nKV heads x W window positions) a split-KV block serves
MAX_SPLIT_QUERIES = 16
#: split-KV blocks wanted on each SM before empty splits exit
SPLIT_BLOCKS_PER_SM = 8
_fn = None


def reset_launches():
    """Set every launch count to 0."""
    global LAUNCHES, PAGED_LAUNCHES
    LAUNCHES = 0
    PAGED_LAUNCHES = 0
    for counts in (MODE_LAUNCHES, INSTANCE_LAUNCHES):
        for key in counts:
            counts[key] = 0


def kernel_instance(q_dtype, kv_dtype, W: int, nH: int, nKV: int,
                    hD: int) -> str:
    """The instance a CUDA call runs: "split" (split-KV on the CUDA cores)
    when a kv head's nH/nKV heads x W window positions are at most
    ``MAX_SPLIT_QUERIES``; else "tc" (tensor cores) for bf16 q and bf16
    K/V at hD >= 32, what every prefill path passes; else "simt" (the
    query-tile kernel on the CUDA cores)."""
    if nH // nKV * W <= MAX_SPLIT_QUERIES:
        return "split"
    if q_dtype == kv_dtype == torch.bfloat16 and hD >= 32:
        return "tc"
    return "simt"


def decode_plan(B: int, nKV: int, T: int, n_sm: int):
    """(n_split, split_len) of the split-KV instance: T cut into runs of
    whole ``SPLIT_ROWS``-row stages, enough runs for some
    ``SPLIT_BLOCKS_PER_SM`` blocks of (split, kv head, slot) an SM, and
    at least two stages a run where T has them (a block's ring is two
    stages deep).  Fixed by the shapes alone: never by pos, never by the
    layout."""
    stages = -(-T // SPLIT_ROWS)
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // (B * nKV))
    per = min(stages, max(2, -(-stages // min(stages, max(1, want)))))
    split_len = per * SPLIT_ROWS
    return -(-T // split_len), split_len


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _history_len(keys, block_tables):
    """T: the cache rows of a slot (paged: max_blocks * block_size)."""
    k, _ = _split_kv(keys)
    return k.shape[1] * (1 if block_tables is None
                         else block_tables.shape[1])


def kernel_plan(q, keys, block_tables=None) -> dict:
    """What a CUDA call with these operands runs: its instance and, for
    split-KV, the split count and length (``keys`` is the cache or the
    pool, ``block_tables`` the paged layout's tables)."""
    k, _ = _split_kv(keys)
    B, W, nH, hD = q.shape
    inst = kernel_instance(q.dtype, k.dtype, W, nH, k.shape[2], hD)
    plan = {"instance": inst}
    if inst == "split":
        plan["splits"], plan["split_len"] = decode_plan(
            B, k.shape[2], _history_len(keys, block_tables),
            _sm_count(q.device))
    return plan


def _split_kv(x):
    """(data, scale) for an int8 operand, (data, None) otherwise."""
    if isinstance(x, tuple):
        if len(x) != 2:
            raise ValueError("a quantized K/V operand is a (data, scale) "
                             "pair")
        return x
    return x, None


def kv_mode(keys) -> str:
    """The storage mode of a K/V operand: "dense", "int8" or "fp8"."""
    data, _ = _split_kv(keys)
    if data.dtype == torch.int8:
        return "int8"
    if data.dtype == torch.float8_e4m3fn:
        return "fp8"
    return "dense"


def _check_kv(q, keys, values, what):
    """Shape, storage and device checks shared by both layouts; returns
    (k, k_scale, v, v_scale)."""
    k, ks = _split_kv(keys)
    v, vs = _split_kv(values)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q and {what} must be 4-D")
    B, W, nH, hD = q.shape
    if k.shape != v.shape:
        raise ValueError(f"keys {tuple(k.shape)} and values "
                         f"{tuple(v.shape)} differ in shape")
    if k.shape[3] != hD:
        raise ValueError(f"q {tuple(q.shape)} does not match {what} "
                         f"{tuple(k.shape)} in head dim")
    nKV = k.shape[2]
    if nKV < 1 or nH % nKV:
        raise ValueError(f"{nH} query heads are not a multiple of "
                         f"{nKV} kv heads")
    if hD not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hD} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _Q_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (q.dtype, *_KV_CODE):
        raise TypeError(f"keys/values must share q's dtype {q.dtype}, "
                        f"int8 or float8_e4m3fn, got {k.dtype}/{v.dtype}")
    quant = k.dtype == torch.int8
    if quant != (ks is not None) or quant != (vs is not None):
        raise TypeError("int8 keys/values travel as (data, scale) pairs, "
                        "and only int8 carries scales")
    if quant:
        want = tuple(k.shape[:3]) + (1,)
        for s in (ks, vs):
            if s.dtype != torch.float32 or tuple(s.shape) != want:
                raise ValueError(f"scales must be float32 {want}, got "
                                 f"{s.dtype} {tuple(s.shape)}")
    tensors = [q, k, v] + ([ks, vs] if quant else [])
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"q and {what} lie on different devices: "
                         f"{sorted(map(str, devs))}")
    return k, ks, v, vs


def _check_pos(pos, B, device):
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be int32 [{B}], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if pos.device != device:
        raise ValueError(f"pos lies on {pos.device}, q on {device}")


def _check(q, keys, values, pos):
    k, ks, v, vs = _check_kv(q, keys, values, "keys/values "
                             "([B, W, nH, hD] and [B, T, nKV, hD])")
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} does not match keys "
                         f"{tuple(k.shape)} in batch")
    _check_pos(pos, q.shape[0], q.device)
    return k, ks, v, vs


def _check_paged(q, key_pool, value_pool, block_tables, pos):
    k, ks, v, vs = _check_kv(q, key_pool, value_pool, "the pools "
                             "([B, W, nH, hD] and [nb, bs, nKV, hD])")
    B = q.shape[0]
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B or block_tables.shape[1] < 1:
        raise ValueError(f"block_tables must be int32 [{B}, max_blocks], "
                         f"got {block_tables.dtype} "
                         f"{tuple(block_tables.shape)}")
    if block_tables.device != q.device:
        raise ValueError(f"block_tables lie on {block_tables.device}, q "
                         f"on {q.device}")
    _check_pos(pos, B, q.device)
    return k, ks, v, vs


def flash_decode_attention_plain(q, keys, values, pos):
    """The kernel's function in plain PyTorch, float32 math: K/V
    dequantized to float32 (int8 data times its scale, fp8 widened),
    masked scores, exp against the row max, P.V divided by
    max(l, 1e-30), cast to q's dtype."""
    B, W, nH, hD = q.shape
    k = dequantize_kv(keys)
    v = dequantize_kv(values)
    T, nKV = k.shape[1], k.shape[2]
    if nKV != nH:
        k = k.repeat_interleave(nH // nKV, dim=2)
        v = v.repeat_interleave(nH // nKV, dim=2)
    s = torch.einsum("bwhd,bthd->bhwt",
                     q.float() * (1.0 / math.sqrt(hD)), k)
    rows = torch.arange(T, device=q.device)
    qidx = torch.arange(W, device=q.device)
    allowed = (rows[None, None, :]
               <= pos[:, None, None].long() + qidx[None, :, None])
    allowed = allowed[:, None]                          # [B, 1, W, T]
    s = s.masked_fill(~allowed, _NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * allowed
    l = p.sum(-1).clamp_min(1e-30)                      # [B, nH, W]
    out = torch.einsum("bhwt,bthd->bwhd", p, v)
    return (out / l.transpose(1, 2)[..., None]).to(q.dtype)


def flash_decode_split_plain(q, keys, values, pos, split_len: int,
                             n_split=None):
    """The split-KV rule in plain PyTorch, float32 math: split s covers
    cache rows [s * split_len, (s + 1) * split_len) and yields, per query,
    its max m_s of the visible scores (-1e30 when it sees none), l_s = sum
    of exp(score - m_s) and acc_s = P_s . V; the merge, in split order,
    is sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30), a
    split with l_s = 0 adding nothing.  ``n_split`` may exceed the splits
    T needs: the extra ones are empty."""
    B, W, nH, hD = q.shape
    k = dequantize_kv(keys)
    v = dequantize_kv(values)
    T, nKV = k.shape[1], k.shape[2]
    if n_split is None:
        n_split = -(-T // split_len)
    if nKV != nH:
        k = k.repeat_interleave(nH // nKV, dim=2)
        v = v.repeat_interleave(nH // nKV, dim=2)
    s = torch.einsum("bwhd,bthd->bhwt",
                     q.float() * (1.0 / math.sqrt(hD)), k)
    rows = torch.arange(T, device=q.device)
    allowed = (rows[None, None, :] <= pos[:, None, None].long()
               + torch.arange(W, device=q.device)[None, :, None])[:, None]
    ms, ls, accs = [], [], []
    for sp in range(n_split):
        inside = (rows >= sp * split_len) & (rows < (sp + 1) * split_len)
        ok = allowed & inside
        m = s.masked_fill(~ok, _NEG_INF).amax(-1)       # [B, nH, W]
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhwt,bthd->bhwd", p, v))
    M = torch.stack(ms).amax(0)
    num = torch.zeros_like(accs[0])
    den = torch.zeros_like(M)
    for m, l, acc in zip(ms, ls, accs):
        w = torch.where(l > 0, torch.exp(m - M), 0.0)
        num = num + w[..., None] * acc
        den = den + w * l
    out = num / den.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _gather_pages(pool, block_tables):
    """[B, mb*bs, ...] view of each slot's pages: ids clamped into the
    pool (-1 reads page 0, an id past the pool its last page, as an XLA
    gather clamps)."""
    B, mb = block_tables.shape
    nb = kv_components(pool)[0].shape[0]
    safe = block_tables.clamp(0, nb - 1).long()
    return kv_map(lambda a: byte_view(a)[safe].view(a.dtype).reshape(
        (B, mb * a.shape[1]) + tuple(a.shape[2:])), pool)


def flash_decode_paged_plain(q, key_pool, value_pool, block_tables, pos):
    """The paged kernel's function in plain PyTorch: gather each slot's
    pages (``pool[max(bt, 0)]``) into a contiguous history and run
    :func:`flash_decode_attention_plain` on it."""
    return flash_decode_attention_plain(
        q, _gather_pages(key_pool, block_tables),
        _gather_pages(value_pool, block_tables), pos)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_decode").pt_flash_decode
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
                       + [ctypes.c_longlong] * 15
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _strides(t, vec):
    """Element strides of axes 0..2 of a 4-D operand, checked for the
    kernel's 16-byte vector loads (an axis of size 1 is never stepped,
    so its stride is passed as 0)."""
    if t.stride(3) != 1:
        raise ValueError(f"last axis must be contiguous, strides "
                         f"{t.stride()}")
    out = []
    for ax in range(3):
        s = 0 if t.shape[ax] == 1 else t.stride(ax)
        if s % vec:
            raise ValueError(f"stride {s} of axis {ax} is not a multiple "
                             f"of {vec} elements (16-byte loads)")
        out.append(s)
    if t.data_ptr() % 16:
        raise ValueError("operand is not 16-byte aligned")
    return out


def _scale_strides(s):
    """Element strides of axes 0..2 of a [*, *, nKV, 1] scale tensor
    (read one float at a time: no alignment beyond float32's)."""
    if s is None:
        return [0, 0, 0]
    return [0 if s.shape[ax] == 1 else s.stride(ax) for ax in range(3)]


def _launch(q, k, ks, v, vs, pos, block_tables=None):
    global LAUNCHES, PAGED_LAUNCHES
    B, W, nH, hD = q.shape
    nKV = k.shape[2]
    out = torch.empty((B, W, nH, hD), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    plan = kernel_plan(q, k, block_tables)
    n_split, split_len = plan.get("splits", 1), plan.get("split_len", 0)
    part_acc = part_ml = None
    if n_split > 1:
        # one scratch: acc [n_split, B, W, nH, hD], then m and l
        # [2, n_split, B, W, nH]
        rows = n_split * B * W * nH
        part = torch.empty((rows * (hD + 2),), dtype=torch.float32,
                           device=q.device)
        part_acc, part_ml = part[:rows * hD], part[rows * hD:]
    vec = 16 // k.element_size()
    qs = _strides(q, 16 // q.element_size())
    kst, vst = _strides(k, vec), _strides(v, vec)
    pos = pos.contiguous()
    if block_tables is None:
        bt_ptr, mb, bs, nb, T = None, 0, 0, 0, k.shape[1]
    else:
        block_tables = block_tables.contiguous()
        bt_ptr = block_tables.data_ptr()
        mb, bs, nb = block_tables.shape[1], k.shape[1], k.shape[0]
        T = mb * bs
    kv_code = _KV_CODE.get(k.dtype, _Q_CODE[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(),
        pos.data_ptr(), bt_ptr, out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        _INSTANCE_CODE[plan["instance"]], n_split, split_len,
        _Q_CODE[q.dtype], kv_code, B, W, T, nH, nKV, hD, mb, bs, nb,
        *qs, *kst, *vst, *_scale_strides(ks), *_scale_strides(vs),
        1.0 / math.sqrt(hD), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA "
                           f"error {rc}")
    if block_tables is None:
        LAUNCHES += 1
    else:
        PAGED_LAUNCHES += 1
    MODE_LAUNCHES[kv_mode(k)] += 1
    INSTANCE_LAUNCHES[plan["instance"]] += 1
    return out


def _device_gate(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return q.device.type == "cpu"


def flash_decode_attention(q, keys, values, pos):
    """Contiguous-layout flash decoding attention.

    q [B, W, nH, hD] (W query positions per slot, fed at positions
    pos..pos+W-1); keys/values [B, T, nKV, hD] INCLUDING the window's
    own just-written K/V — bare tensors in q's dtype or in
    float8_e4m3fn, or int8 ``(data, scale [B, T, nKV, 1] float32)``
    pairs; pos [B] int32 (>= 0).  Query j of slot b attends cache rows
    < pos[b] + j + 1, so W = 1 is the decode step and pos = 0, W = S is
    causal prefill.  GQA via head grouping.  Returns [B, W, nH, hD] in
    q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (q float32 or bfloat16, hD in 16/32/64/128, last axis contiguous,
    other strides and the bases 16-byte aligned) or raise."""
    k, ks, v, vs = _check(q, keys, values, pos)
    if _device_gate(q, "flash_decode_attention"):
        return flash_decode_attention_plain(q, keys, values, pos)
    return _launch(q, k, ks, v, vs, pos)


def flash_decode_paged(q, key_pool, value_pool, block_tables, pos):
    """Paged-layout flash decoding attention over a shared page pool.

    q [B, W, nH, hD]; key_pool/value_pool [num_blocks, block_size, nKV,
    hD] (same storage modes as :func:`flash_decode_attention`, int8
    scales [num_blocks, block_size, nKV, 1]); block_tables [B,
    max_blocks] int32 page ids, -1 = unallocated, read as page 0 — such
    pages must back only rows past every query's length, which the
    kernel then never reads (an id past the pool reads its last page:
    no read leaves the pool); pos [B] int32.  Same mask contract as the
    contiguous form over the slot's logical history of max_blocks *
    block_size rows.

    CPU tensors run :func:`flash_decode_paged_plain`; CUDA tensors
    launch the kernel or raise."""
    k, ks, v, vs = _check_paged(q, key_pool, value_pool, block_tables, pos)
    if _device_gate(q, "flash_decode_paged"):
        return flash_decode_paged_plain(q, key_pool, value_pool,
                                        block_tables, pos)
    return _launch(q, k, ks, v, vs, pos, block_tables)
