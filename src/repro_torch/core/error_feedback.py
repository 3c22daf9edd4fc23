"""Deprecated shim — port of ``repro.core.error_feedback``.

Error feedback is the wire layer :class:`repro_torch.core.wire.ef.EFCodec`:
set ``CompressionConfig.error_feedback=True`` and thread the residual
through :func:`repro_torch.core.collectives.compressed_mean_stateful` (the
bucketed train step does so through ``repro_torch.train.bucketing
.init_ef_state`` and ``sync_grads_bucketed``).  This name stays so that the
reference's callers have one here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import collectives
from repro_torch.core import types as t


def compressed_mean_ef(x, err, key, cfg: t.CompressionConfig, comm):
    """Deprecated: one error-feedback round over the communicator's ranks;
    returns (estimate, new_err).  Forces ``error_feedback=True`` on ``cfg``
    and runs :func:`~repro_torch.core.collectives.compressed_mean_stateful`."""
    if not cfg.error_feedback:
        cfg = dataclasses.replace(cfg, error_feedback=True)
    return collectives.compressed_mean_stateful(x, err, key, cfg, comm)
