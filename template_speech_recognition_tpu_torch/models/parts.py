"""Parts-based feature coding.

Counterpart of ``template_speech_recognition_tpu.models.parts``: a
dictionary of small binary patches ("parts") is learned by Bernoulli
mixture EM over random crops of edge maps, and maps are re-coded as
part-indicator maps.  The coding step's per-location log-likelihood

    ll[t, f, j] = sum_{dt, df, e} logit_j[dt, df, e] * X[t + dt, f + df, e]
                  + offset_j

is a valid 2-D cross-correlation with J output channels: one
``F.conv2d`` in full float32 (the reference's ``lax.conv_general_dilated``
at ``Precision.HIGHEST``, outside any Pallas kernel; cuDNN's default
TF32 would move the argmax).  Patch sampling and the EM's initial
responsibilities are the oracle's (``oracle.parts.extract_random_patches``,
``oracle.mixture.init_responsibilities``), so a dictionary learned here
is comparable with the reference's, seed for seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from template_speech_recognition_tpu_torch.models.mixture import bernoulli_mixture_em
from template_speech_recognition_tpu_torch.utils.device import resolve_device
from template_speech_recognition_tpu_torch.utils.precision import full_fp32

# maps a conv2d call in ``code_parts_batch``: bounds its [B, J, T', F']
# float32 log-likelihoods (~0.2 GB at 30 frames x F' 252 x J 32)
CODE_CHUNK = 256


def learn_parts(feature_maps, num_parts: int, patch_time: int = 5, patch_freq: int = 5,
                num_patches: int = 2000, seed: int = 0, num_iters: int = 30,
                eps: float = 0.01, device=None) -> torch.Tensor:
    """Learn a part dictionary [num_parts, pt, pf, E] on ``device``.

    ``feature_maps``: host arrays [T_i, F, E] (each cut to its valid
    frames); the patches are drawn on the host by the oracle's sampler
    (the reference's RNG stream), the EM runs on the device."""
    from oracle.mixture import init_responsibilities
    from oracle.parts import extract_random_patches

    dev = resolve_device(device)
    patches = extract_random_patches(feature_maps, patch_time, patch_freq, num_patches, seed)
    resp = init_responsibilities(patches.shape[0], num_parts, seed + 1)
    state = bernoulli_mixture_em(torch.from_numpy(patches).to(dev), resp,
                                 num_iters=num_iters, eps=eps)
    e = feature_maps[0].shape[2]
    return state.means.reshape(num_parts, patch_time, patch_freq, e)


def _filters(parts: torch.Tensor):
    """parts [J, pt, pf, E] -> (conv2d weight [J, E, pt, pf], offset [J])."""
    p = parts.to(torch.float32).clamp(1e-4, 1 - 1e-4)
    logit = torch.log(p) - torch.log1p(-p)
    offset = torch.log1p(-p).sum(dim=(1, 2, 3))
    return logit.permute(0, 3, 1, 2).contiguous(), offset


def _logliks(maps: torch.Tensor, weight, offset, stride_time, stride_freq):
    """maps [B, T, F, E] -> [B, T', F', J] float32."""
    lhs = maps.to(torch.float32).permute(0, 3, 1, 2)                # [B, E, T, F]
    with full_fp32():
        ll = F.conv2d(lhs, weight, stride=(stride_time, stride_freq))
    return ll.permute(0, 2, 3, 1) + offset


def part_logliks(feature_map: torch.Tensor, parts: torch.Tensor, stride_time: int = 1,
                 stride_freq: int = 1) -> torch.Tensor:
    """Bernoulli log-likelihood [T', F', J] of every (strided) patch
    location of ``feature_map`` [T, F, E] under every part."""
    weight, offset = _filters(parts)
    return _logliks(feature_map[None], weight, offset, stride_time, stride_freq)[0]


def _code(ll: torch.Tensor, loglik_threshold: float) -> torch.Tensor:
    """One-hot of the first-max part where its log-likelihood clears the
    threshold: [.., J] float -> [.., J] bool."""
    onehot = torch.zeros(ll.shape, dtype=torch.bool, device=ll.device)
    onehot.scatter_(-1, torch.argmax(ll, dim=-1, keepdim=True), True)
    return onehot & (ll.amax(dim=-1, keepdim=True) >= loglik_threshold)


def code_parts(feature_map: torch.Tensor, parts: torch.Tensor,
               loglik_threshold: float = float("-inf"), stride_time: int = 1,
               stride_freq: int = 1) -> torch.Tensor:
    """Re-code a binary map [T, F, E] as a part-indicator map [T', F', J]
    bool (oracle: ``oracle.parts.code_parts``)."""
    return _code(part_logliks(feature_map, parts, stride_time, stride_freq),
                 loglik_threshold)


def code_parts_batch(feature_maps: torch.Tensor, parts: torch.Tensor,
                     loglik_threshold: float = float("-inf"), stride_time: int = 1,
                     stride_freq: int = 1) -> torch.Tensor:
    """``code_parts`` over a padded batch [B, T, F, E] -> [B, T', F', J],
    ``CODE_CHUNK`` maps a convolution."""
    weight, offset = _filters(parts)
    out = [
        _code(_logliks(feature_maps[i : i + CODE_CHUNK], weight, offset, stride_time,
                       stride_freq), loglik_threshold)
        for i in range(0, feature_maps.shape[0], CODE_CHUNK)
    ]
    return torch.cat(out)
