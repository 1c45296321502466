"""Self-attention: kernels K1 (forward) and K2 (backward), their plain
versions, the autograd Function that joins them, and the routing.

Counterpart of ``lidar_layout_tpu/ops/pallas_attention.py``. The kernels are
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu`` (CUDA C++ for
sm_90a; each header says what bounds it and how it is built around that).

``flash_attention`` takes the plain versions only for tensors on the CPU; for
CUDA tensors it launches the kernels or raises. When a gradient is needed it
runs through ``_FlashAttention``: the forward (K1) also writes the per-row
f32 log-sum-exp, and the backward (K2) recomputes the probabilities from it,
FlashAttention-2 style. The log-sum-exp is taken less the largest key bias
of the batch row (``_row_bias_max``): a row whose every key carries the
padding bias (-1e9) attends uniformly, since its products round away next
to -1e9, and an lse near -1e9 would lose log S to f32 rounding, so the
recomputed probabilities would not be the forward's. The key bias is a
padding mask and gets no gradient (the JAX package returns zeros for it). ``attend`` routes the same cases as
the JAX package: self-attention with no mask or with a key-padding mask goes
to ``flash_attention``; anything else goes to plain attention.

``flash_attention_xl`` is K1 with a key count of its own (S_kv != S_q):
the queries of one W shard of an attention level against the keys of every
shard (the spatial ``sp`` axis, ``models/unet.SelfAttentionBlock``). It is
called directly and forward only; ``attend`` does not route to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _attend_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kbias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain BHSD attention, f32 logits and softmax (the JAX ``_attend_ref``).

    kbias: optional (B, S_k) f32 additive logit bias (e.g. -1e9 on padding).
    """
    p = torch.softmax(_logits_ref(q, k, kbias), dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _logits_ref(q: torch.Tensor, k: torch.Tensor,
                kbias: Optional[torch.Tensor]) -> torch.Tensor:
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if kbias is not None:
        s = s + kbias.float()[:, None, None, :]
    return s


def _row_bias_max(kbias: Optional[torch.Tensor]):
    """(B, 1, 1, 1) largest key bias of each batch row, or 0 without a bias."""
    return 0.0 if kbias is None else kbias.float().amax(dim=-1)[:, None, None, None]


def _lse_ref(q: torch.Tensor, k: torch.Tensor,
             kbias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row f32 log-sum-exp of the logits less the batch row's largest key
    bias, (B, H, S): K1's second output (the plain log-sum-exp where a row
    has a key with bias 0, as every padding mask does but a padding patch's)."""
    return torch.logsumexp(_logits_ref(q, k, kbias) - _row_bias_max(kbias), dim=-1)


def _attend_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                    kbias: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain attention backward, the math of kernel K2.

    P is recomputed from the saved log-sum-exp (less the row's largest key
    bias, as ``_lse_ref``), ``dS = P*(dP - delta)``; P
    and dS are rounded to the input dtype before their products (as the TPU
    kernel rounds them), everything is summed in f32 and dq/dk/dv come back
    in the input dtypes. ``delta`` is ``rowsum(P*dP)``, the softmax vjp's own
    sum as XLA takes it. It equals K2's ``rowsum(dO*O)`` in exact arithmetic,
    and with one key (P = 1 exactly) it makes dS exactly 0, so dq and dk are
    JAX's zeros: ``rowsum(dO*O)`` and ``dP = dO v`` are two sums of the same
    products in other orders here, which can differ in the last bit.
    ``o`` is unused; it stays in the signature K2 shares.
    """
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(_logits_ref(q, k, kbias) - _row_bias_max(kbias) - lse.float()[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    pc, dsc = p.to(v.dtype).float(), ds.to(q.dtype).float()
    dv = torch.matmul(pc.transpose(-1, -2), dof)
    dk = torch.matmul(dsc.transpose(-1, -2), qf) * scale
    dq = torch.matmul(dsc, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_cost(b: int, h: int, s: int, d: int, itemsize: int,
                   backward: bool = False, s_kv: Optional[int] = None) -> dict:
    """Work of one call of K1 (or K2 when ``backward``) on (B, H, S, D) in a
    dtype of ``itemsize`` bytes, counted as the JAX package's
    ``pl.CostEstimate`` counts it: ``flops`` (4 B H S^2 D forward, 10 backward),
    ``transcendentals`` (B H S^2 exponentials) and ``bytes`` (q, k, v read and
    o written; backward q, k, v, o, dO read and dq, dk, dv written, here in
    the input dtype where the TPU kernel wrote f32). ``s_kv``: the forward
    over S_kv keys (``flash_attention_xl``), S^2 becoming S S_kv and k and
    v counted at S_kv rows."""
    if s_kv is not None:
        return {"flops": 4 * b * h * s * s_kv * d, "transcendentals": b * h * s * s_kv,
                "bytes": 2 * b * h * (s + s_kv) * d * itemsize}
    bhsd = b * h * s * d
    return {"flops": (10 if backward else 4) * bhsd * s,
            "transcendentals": b * h * s * s,
            "bytes": (8 if backward else 4) * bhsd * itemsize}


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """A view the kernel reads directly (16-byte aligned rows, contiguous D),
    else a contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cross: bool = False) -> None:
    """Raise on what K1/K2 do not take; ``cross``: k and v may hold another
    number of keys than q holds queries (K1 only)."""
    if not q.is_cuda:
        raise ValueError(f"flash attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32/bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    kv_shape = (*q.shape[:2], k.shape[2], q.shape[3]) if cross else q.shape
    if k.shape != kv_shape or v.shape != kv_shape:
        raise ValueError(f"{'cross-length' if cross else 'self-'}attention needs "
                         f"{'(B, H, S_kv, D) k and v beside q' if cross else 'equal q/k/v shapes'}"
                         f", got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if d % 8 or d > 128 or s == 0 or k.shape[2] == 0 or b * h * -(-s // 128) > 2**31 - 1:
        raise ValueError(f"unsupported attention shape {tuple(q.shape)}")


def _bias_ready(kbias: Optional[torch.Tensor], k: torch.Tensor) -> Optional[torch.Tensor]:
    if kbias is None:
        return None
    b, _, s, _ = k.shape
    return kbias.to(device=k.device, dtype=torch.float32).expand(b, s).contiguous()


def _bshd_empty(q: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) view of a (B, S, H, D) buffer: the caller's projections
    read (B, S, H*D) with no copy."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*(st for t in ts for st in t.stride()[:3]))


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kbias: Optional[torch.Tensor],
         with_lse: bool, cross: bool, what: str
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of K1: (o, the f32 (B, H, S) log-sum-exp when ``with_lse``
    else None)."""
    _check_inputs(q, k, v, cross)
    launch = _build.launcher("flash_attn_fwd")
    b, h, s, d = q.shape
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    o = _bshd_empty(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kbias = _bias_ready(kbias, k)
    strides = _strides(q, k, v, o)
    _build.launch(
        launch, q.device, what,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kbias is None else kbias.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        ctypes.cast(strides, ctypes.c_void_p), _DTYPES[q.dtype], b, h, s, k.shape[2], d,
        torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kbias: Optional[torch.Tensor], with_lse: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 on self-attention: (o, the f32 (B, H, S) log-sum-exp when
    ``with_lse`` else None)."""
    out = _fwd(q, k, v, kbias, with_lse, False, "flash_attention")
    flash_attention.launches += 1
    return out


def _launch_xl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1 on cross-length shapes: q (B, H, S_q, D), k and v (B, H, S_kv, D)."""
    o, _ = _fwd(q, k, v, None, False, True, "flash_attention_xl")
    flash_attention_xl.launches += 1
    return o


_KEY_BLOCK = 128   # keys a K2 block owns (kBKV in flash_attn_bwd.cu)


def dq_partials(s: int) -> int:
    """f32 partials of dq that K2's bf16 path writes at sequence length s,
    one a key block of 128 keys, summed in index order by a last pass."""
    return -(-s // _KEY_BLOCK)


def _launch_bwd(q, k, v, o, do, lse, kbias):
    _check_inputs(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("o, dO must match q and lse must be (B, H, S)")
    launch = _build.launcher("flash_attn_bwd")
    b, h, s, d = q.shape
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    o, do = (_kernel_ready(t.to(q.dtype)) for t in (o, do))
    lse = lse.to(torch.float32).contiguous()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    # bf16 over more than one key block: each block's f32 partial of dq
    blocks = dq_partials(s)
    dqpart = (torch.empty((blocks, b, h, s, d), dtype=torch.float32, device=q.device)
              if q.dtype == torch.bfloat16 and blocks > 1 else None)
    dq, dk, dv = _bshd_empty(q), _bshd_empty(q), _bshd_empty(q)
    kbias = _bias_ready(kbias, k)
    strides = _strides(q, k, v, o, do, dq, dk, dv)
    _build.launch(
        launch, q.device, "flash_attention_bwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        None if kbias is None else kbias.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if dqpart is None else dqpart.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        ctypes.cast(strides, ctypes.c_void_p), _DTYPES[q.dtype], b, h, s, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        kbias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of self-attention from the forward's output ``o`` and
    log-sum-exp ``lse``: kernel K2 for CUDA tensors, the plain version for
    CPU tensors."""
    if q.device.type == "cpu":
        return _attend_bwd_ref(q, k, v, o, do, lse, kbias)
    return _launch_bwd(q, k, v, o, do, lse, kbias)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward with its log-sum-exp, K2 backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, kbias):
        if q.device.type == "cpu":
            o, lse = _attend_ref(q, k, v, kbias), _lse_ref(q, k, kbias)
        else:
            o, lse = _launch(q, k, v, kbias, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, kbias)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kbias = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, kbias)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kbias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused self-attention, (B, H, S, D) -> (B, H, S, D), differentiable in
    q, k and v.

    kbias: optional (B, S) f32 additive key bias (key-padding masks).
    Kernel constraints: S_q == S_kv, D % 8 == 0, D <= 128; any S. Under
    autocast q, k and v run in the autocast dtype, as matmuls do.
    """
    if torch.is_autocast_enabled(q.device.type):
        dt = torch.get_autocast_dtype(q.device.type)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kbias)
    if q.device.type == "cpu":
        return _attend_ref(q, k, v, kbias)
    return _launch(q, k, v, kbias)[0]


flash_attention.launches = 0


def flash_attention_xl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention of q (B, H, S_q, D) over k and v (B, H, S_kv, D) with S_kv
    free, (B, H, S_q, D), forward only: K1 for CUDA tensors, the plain
    version (``_attend_ref``, any S_kv) for CPU tensors. The queries of one
    W shard of an attention level against the gathered keys of every shard
    (the ``sp`` axis). D % 8 == 0, D <= 128. Under autocast q, k and v run
    in the autocast dtype."""
    if torch.is_autocast_enabled(q.device.type):
        dt = torch.get_autocast_dtype(q.device.type)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("cross-length attention (the sp axis) is forward-only: run it "
                           "under torch.no_grad()")
    if q.device.type == "cpu":
        return _attend_ref(q, k, v)
    return _launch_xl(q, k, v)


flash_attention_xl.launches = 0


def _supports_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Gate on BSHD tensors, by shape and dtype alone: self-attention
    shapes (q, k and v alike, S in shape[-3]), D in shape[-1] a multiple of 8
    up to 128, one float32 or bfloat16 dtype. The kernels mask the ragged S
    edge, so the TPU kernel's S % 128 rule is gone, and they take any B*H.
    Anything else goes to plain attention, as JAX's ``attend`` sends what its
    kernel does not take to XLA."""
    return (q.ndim == 4 and q.shape == k.shape == v.shape and q.shape[-3] > 0
            and q.shape[-1] <= 128 and q.shape[-1] % 8 == 0
            and q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype)


def _key_padding_bias(mask: Optional[torch.Tensor], b: int,
                      sk: int) -> Optional[torch.Tensor]:
    """(B|1, 1, 1, S_k) boolean key-padding mask -> (B, S_k) additive bias;
    None for any other mask structure."""
    if mask is None or mask.ndim != 4:
        return None
    if mask.shape[1] != 1 or mask.shape[2] != 1 or mask.shape[3] != sk \
            or mask.shape[0] not in (1, b):
        return None
    m = mask[:, 0, 0, :].expand(b, sk)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(m, zero, zero - 1e9)


def _dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain BSHD attention with an optional boolean mask broadcastable to
    (B, H, S_q, S_k) (True = attend), f32 softmax."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BSHD attention: self-attention-shaped inputs (also key-padding-masked
    ones) go through ``flash_attention``; everything else (other masks,
    cross-length) through plain attention."""
    if _supports_flash(q, k, v):
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if mask is None:
            return flash_attention(qh, kh, vh).transpose(1, 2)
        kb = _key_padding_bias(mask, qh.shape[0], kh.shape[-2])
        if kb is not None:
            return flash_attention(qh, kh, vh, kb).transpose(1, 2)
    return _dot_product_attention(q, k, v, mask)
