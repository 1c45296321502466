"""Self-attention forward: kernel K1, its plain version and the routing.

Counterpart of ``lidar_layout_tpu/ops/pallas_attention.py`` (forward only).
The kernel is ``csrc/flash_attn_fwd.cu`` (CUDA C++ for sm_90a; its header
says what bounds it and how it is built around that).

``flash_attention`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises. ``attend`` routes the same
cases as the JAX package: self-attention with no mask or with a key-padding
mask goes to ``flash_attention``; anything else goes to plain attention.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _attend_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kbias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain BHSD attention, f32 logits and softmax (the JAX ``_attend_ref``).

    kbias: optional (B, S_k) f32 additive logit bias (e.g. -1e9 on padding).
    """
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kbias is not None:
        s = s + kbias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """A view the kernel reads directly (16-byte aligned rows, contiguous D),
    else a contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kbias: Optional[torch.Tensor]) -> torch.Tensor:
    if not q.is_cuda:
        raise ValueError(f"flash attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32/bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    launch = _build.launcher("flash_attn_fwd")
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"self-attention needs equal q/k/v shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d % 8 or d > 128 or b * h > 65535:
        raise ValueError(f"unsupported attention shape {tuple(q.shape)}")
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    # written straight in (B, S, H, D) memory order: the caller's output
    # projection reads (B, S, H*D) with no copy
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    kb_ptr = None
    if kbias is not None:
        kbias = kbias.to(device=q.device, dtype=torch.float32).expand(b, s).contiguous()
        kb_ptr = kbias.data_ptr()
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, o)
                                         for st in t.stride()[:3]))
    status = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kb_ptr, o.data_ptr(),
        ctypes.cast(strides, ctypes.c_void_p), _DTYPES[q.dtype], b, h, s, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kbias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused self-attention, (B, H, S, D) -> (B, H, S, D).

    kbias: optional (B, S) f32 additive key bias (key-padding masks).
    Kernel constraints: S_q == S_kv, D % 8 == 0, D <= 128; any S.
    """
    if q.device.type == "cpu":
        return _attend_ref(q, k, v, kbias)
    return _launch(q, k, v, kbias)


flash_attention.launches = 0


def _supports_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Gate on BSHD tensors: S in shape[-3], D in shape[-1]. The kernel masks
    the ragged S edge, so the TPU kernel's S % 128 rule is gone."""
    return (q.shape[-3] == k.shape[-3] and q.shape[-1] <= 128
            and q.shape[-1] % 8 == 0)


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
    if _supports_flash(q, k):
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if mask is None:
            return flash_attention(qh, kh, vh).transpose(1, 2)
        kb = _key_padding_bias(mask, qh.shape[0], kh.shape[-2])
        if kb is not None:
            return flash_attention(qh, kh, vh, kb).transpose(1, 2)
    return _dot_product_attention(q, k, v, mask)
