"""Deterministic synthetic data — port of ``repro.data.pipeline`` (the dense,
MoE, SSM and hybrid families' token batches; the encoder–decoder family's
with their frame embeddings; the VLM family's with their patch
embeddings).

:meth:`SyntheticLM.host_batch` is the reference's numpy code, copied, so
its batches are bit-equal to the reference's for the same seed and step;
:meth:`SyntheticLM.batch` puts one on a device as torch tensors.  A batch is
a pure function of (seed, step), so a restarted run regenerates the same
stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.wire.base import NotPortedError


@dataclasses.dataclass
class SyntheticLM:
    cfg: ArchConfig
    shape: ShapeSpec
    seed: int = 0
    # tokens follow t_{i+1} = (7·t_i + e) mod V with e ~ U[0, noise): a
    # strong bigram structure (H(next|prev) = ln noise) so training loss has
    # a real signal to descend, while staying fully synthetic/deterministic.
    noise: int = 16

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, step]))

    def _tokens(self, rng, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab_size
        noise = min(self.noise, v)
        t0 = rng.integers(0, v, (b, 1), dtype=np.int64)
        steps = rng.integers(0, noise, (b, s - 1), dtype=np.int64)
        out = [t0]
        for i in range(s - 1):
            out.append((out[-1] * 7 + steps[:, i:i + 1]) % v)
        return np.concatenate(out, axis=1).astype(np.int32)

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
            raise NotPortedError(f"synthetic batches of the {cfg.family!r} family are "
                                 "not ported (ROADMAP.md, queue 1)")
        rng = self._rng(step)
        b, s = self.shape.global_batch, self.shape.seq_len
        if cfg.family == "vlm":             # the patches take the first positions
            s -= cfg.num_patches
        tokens = self._tokens(rng, b, s)
        batch = {"tokens": tokens,
                 "labels": np.roll(tokens, -1, axis=1),
                 "mask": np.ones((b, s), np.float32)}
        if cfg.family == "encdec":
            # drawn after the tokens, padded as the reference's pipeline pads
            from repro_torch.models.encdec import enc_seq_padded
            batch["frames"] = rng.standard_normal(
                (b, enc_seq_padded(cfg, 16), cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
        return batch

    def batch(self, step: int, device) -> Dict[str, torch.Tensor]:
        """The global batch of ``step`` on ``device``: tokens and labels
        int32 (B, S), mask f32 (B, S); for the encoder–decoder family
        frames f32 (B, S_enc, D); for the VLM family tokens, labels and
        mask over S − P text positions and patches f32 (B, P, D)."""
        return {k: torch.from_numpy(v).to(device) for k, v in self.host_batch(step).items()}
