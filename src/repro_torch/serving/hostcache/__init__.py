"""Host-memory cache tier: a bounded LRU arena, an asynchronous staging
ring, the durable disk tier below the arena and the ``HostTier`` facade —
the port of the reference's ``serving/hostcache``. Spilled KV blocks,
parked payloads and recurrent-state snapshots share one byte-budgeted
arena between the device prefix cache and fresh prefill; the arena's
victims demote to crc-framed files that a restarted engine hits again."""
from .arena import ArenaStats, HostArena, checksum
from .disk import DiskTier, decode_entry, durable_name, encode_entry
from .staging import StagingRing
from .tier import HostTier, LeafLayout

__all__ = ["ArenaStats", "HostArena", "StagingRing", "HostTier", "checksum",
           "DiskTier", "LeafLayout", "decode_entry",
           "durable_name", "encode_entry"]
