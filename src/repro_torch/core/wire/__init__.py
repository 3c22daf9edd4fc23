"""Wire-codec subsystem: the codecs, their accounting and the registry."""
from repro_torch.core.wire.base import (  # noqa: F401
    NotPortedError, WireCodec, effective_nodes, scatter_axes, scatter_shard_len,
    scatter_word_align)
from repro_torch.core.wire.registry import (  # noqa: F401
    gather_kind, get, names, register, resolve)
