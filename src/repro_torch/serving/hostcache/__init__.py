"""Host-memory cache tier: a bounded LRU arena, an asynchronous staging
ring and the ``HostTier`` facade — the port of the reference's
``serving/hostcache`` without its disk tier. Spilled KV blocks, parked
payloads and recurrent-state snapshots share one byte-budgeted arena
between the device prefix cache and fresh prefill."""
from .arena import ArenaStats, HostArena, checksum
from .staging import StagingRing
from .tier import HostTier

__all__ = ["ArenaStats", "HostArena", "StagingRing", "HostTier", "checksum"]
