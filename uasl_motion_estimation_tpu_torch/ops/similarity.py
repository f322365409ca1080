"""Patch similarity measures: entropy, mutual information, NCC/ZNCC.

Port of ``uasl_motion_estimation_tpu/ops/similarity.py`` (the reference's MI
core, mutual_information.cpp:14-140). ``mutual_information`` keeps the JAX
one-hot formulation (the joint histogram as O_a^T O_b); the batched router
``mutual_information_batched`` quantises once and scores the pairs with the
joint-histogram kernel K2 (``ops/kernels/mi.py``).

All functions accept arbitrary leading batch dims; patches are flattened
internally. Intensities are expected in [0, 256).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import mi as kmi

DEFAULT_BINS = 20  # reference: histSize = 20 (mutual_information.cpp:33, 66)


def _flatten_patch(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H*W); 1-D patches pass through."""
    return img.reshape(*img.shape[:-2], -1) if img.ndim >= 2 else img


def quantise(img: torch.Tensor, bins: int = DEFAULT_BINS, vmax: float = 256.0) -> torch.Tensor:
    """Intensity -> int32 bin ids in [0, bins) (calcHist over [0, 256),
    mutual_information.cpp:48-53)."""
    idx = torch.floor(img.to(torch.float32) * (bins / vmax)).to(torch.int32)
    return torch.clamp(idx, 0, bins - 1)


def _one_hot(img: torch.Tensor, bins: int) -> torch.Tensor:
    return F.one_hot(quantise(img, bins).long(), bins).to(torch.float32)


def histogram(img: torch.Tensor, bins: int = DEFAULT_BINS) -> torch.Tensor:
    """Normalized intensity histogram, (..., bins)."""
    return torch.mean(_one_hot(_flatten_patch(img), bins), dim=-2)


def entropy(img: torch.Tensor, bins: int = DEFAULT_BINS) -> torch.Tensor:
    """Shannon entropy (bits) of the intensity distribution
    (computeEntropy, mutual_information.cpp:28-45)."""
    p = histogram(img, bins)
    pos = p > 0
    logp = torch.where(pos, torch.log2(torch.where(pos, p, torch.ones_like(p))),
                       torch.zeros_like(p))
    return -torch.sum(p * logp, dim=-1)


def joint_histogram(img_a: torch.Tensor, img_b: torch.Tensor, bins: int = DEFAULT_BINS
                    ) -> torch.Tensor:
    """Normalized joint histogram (..., bins, bins) as a one-hot product."""
    a = _one_hot(_flatten_patch(img_a), bins)
    b = _one_hot(_flatten_patch(img_b), bins)
    n = a.shape[-2]
    return torch.einsum("...pi,...pj->...ij", a, b) / n


def mutual_information(img_a: torch.Tensor, img_b: torch.Tensor, bins: int = DEFAULT_BINS
                       ) -> torch.Tensor:
    """MI(a, b) in bits between two equally-shaped patches
    (computeMutualInformation, mutual_information.cpp:55-86)."""
    return kmi.mi_from_joint(joint_histogram(img_a, img_b, bins))


def mutual_information_batched(
    img_a: torch.Tensor,
    img_b: torch.Tensor,
    bins: int = DEFAULT_BINS,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """MI over broadcastable patch batches (..., H, W), scored by kernel K2.

    The patches are quantised once and go to ``kernels.mi.mi_pairs``: on a
    CUDA tensor the CUDA kernel, on a CPU tensor its plain version. A
    (..., N, 1, H, W) x (..., N, D, H, W) pairing (one patch against D
    others) reaches the kernel as ``rep = D`` without writing the left ids
    out D times; other broadcasts are expanded first. The MI matcher does
    not come here: it scores its strips with ``kernels.mi.mi_strip``.

    ``use_pallas`` keeps the JAX field's meaning for configs carried across:
    None or True take K2; False takes the one-hot ``mutual_information``,
    which only a CPU tensor may ask for.
    """
    if use_pallas is False:
        if img_a.device.type != "cpu" or img_b.device.type != "cpu":
            raise ValueError("mutual_information_batched: use_pallas=False asks for the "
                             "one-hot path, which runs only on CPU tensors")
        return mutual_information(img_a, img_b, bins)
    if img_a.shape[-2:] != img_b.shape[-2:]:
        raise ValueError(f"patch shapes differ: {tuple(img_a.shape)} vs {tuple(img_b.shape)}")
    npix = img_a.shape[-2] * img_a.shape[-1]
    lead = torch.broadcast_shapes(img_a.shape[:-2], img_b.shape[:-2])
    qa = quantise(img_a, bins)
    qb = quantise(img_b, bins)
    lead_a = (1,) * (len(lead) - (img_a.ndim - 2)) + tuple(img_a.shape[:-2])
    lead_b = (1,) * (len(lead) - (img_b.ndim - 2)) + tuple(img_b.shape[:-2])
    rep = 1
    if (len(lead) >= 1 and lead_b == tuple(lead) and lead_a[-1] == 1
            and lead_a[:-1] == tuple(lead[:-1])):
        rep = lead[-1]
    else:
        qa = qa.expand(*lead, *qa.shape[-2:])
    qb = qb.expand(*lead, *qb.shape[-2:])
    out = kmi.mi_pairs(qa.reshape(-1, npix).contiguous(), qb.reshape(-1, npix).contiguous(),
                       rep=rep, n_valid=npix, bins=bins)
    return out.reshape(lead)


def ncc(img_a: torch.Tensor, img_b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Plain (non-centered) normalized cross-correlation (comparePC,
    mutual_information.cpp:14-25)."""
    a = _flatten_patch(img_a).to(torch.float32)
    b = _flatten_patch(img_b).to(torch.float32)
    num = torch.sum(a * b, dim=-1)
    den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1))
    return num / torch.clamp(den, min=eps)


def zncc(img_a: torch.Tensor, img_b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Zero-mean normalized cross-correlation (TM_CCOEFF_NORMED semantics)."""
    a = _flatten_patch(img_a).to(torch.float32)
    b = _flatten_patch(img_b).to(torch.float32)
    a = a - torch.mean(a, dim=-1, keepdim=True)
    b = b - torch.mean(b, dim=-1, keepdim=True)
    num = torch.sum(a * b, dim=-1)
    den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1))
    return num / torch.clamp(den, min=eps)
