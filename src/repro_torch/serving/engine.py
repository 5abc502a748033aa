"""`ServingEngine`: paged predictive-sampling serving, on one device or on
a data-parallel mesh.

The port of the reference's ``serving/engine.py``:

* **Mesh** — a ``ServingTopology`` splits the batch slots into contiguous
  per-shard ranges, and each data shard owns a paged cache on its own
  device: a block sub-pool with its own sink block 0 and prefix cache, the
  recurrent rows and the ``tokens``/``n``/``cand`` rows of its slots
  (``_Shard``). Block tables hold shard-local ids. Each step dispatches
  every shard's round loop over its own rows, tables and pool, then reads
  every shard's stats; no tensor crosses shards on the round path, and
  each shard's loop stops on its own rows. Admission routes a request to
  the shard with the most block headroom; ``migrate_slot`` moves a live
  sequence to another slot (across shards its blocks are copied into the
  destination's sub-pool), and admission **rebalances** by migrating a
  resident when no shard can take an arrival alone (``rebalance``).
  ``ServingTopology()`` is the single-device case: one shard, the same
  code.

* **Paged KV cache** — attention K/V (GQA) or the latent cache (MLA)
  lives in fixed-size blocks of a shared physical pool; verify rounds and
  prefill decode through the block tables (``decode_window_paged``). On
  the GPU every layer runs its fused paged-decode kernel (GQA or latent),
  which attends through the table and commits the window in the same
  launch; ``use_attention_kernel=False`` takes the gather-view fallback
  (writeback kernel, gathered view, plain attention).
  ``paged_attention=False`` is the legacy dense round: each round gathers
  a dense view through the tables, decodes it (on the card through the
  dense decode kernel) and writes the window back through the writeback
  kernel (``scatter_paged``).
* **Recurrent states** — RWKV-6 and Mamba layers carry one state row per
  batch slot instead of KV blocks; rounds and prefill adopt the state at
  the accept point into the slot's row in place, on the GPU through the
  WKV kernel (``use_attention_kernel`` picks the mixers' kernels). A
  slot's row is zeroed when it is freed and when a request is admitted to
  it.
* **Prefix cache** — full prompt blocks are content-hashed (chained keys);
  admissions sharing a prompt prefix point their tables at the cached
  blocks and skip recomputing them. A stack with recurrent layers, whose
  state after a prefix is not paged, reaches a prefix only through the host
  tier's state snapshots (``rec_prefix``).
* **Host tier** (the reference's DESIGN.md §13; ``host_cache_mb``, 256 MiB
  or ``REPRO_HOST_CACHE_MB`` by default, 0 turns it off) — one
  byte-budgeted arena of host memory (pinned on CUDA,
  ``serving/hostcache``) behind the device prefix cache: a hashed block
  evicted from the pool is spilled to it (one D2H copy per dtype), and a
  later admission that misses on the device restages the contiguous
  resident run through the staging ring (a copy stream and events) instead
  of prefilling it; with ``staging_slots`` the blocks of queued requests
  are prefetched while they wait (``host_prefetch``). Recurrent stacks
  split their prefill at block boundaries and snapshot the state rows at
  each into the tier; an admission resumes from the largest boundary
  covered on both sides. A preemption parks through the tier: shared full
  prompt blocks once, pinned, in the ``kv`` namespace; the private tail and
  recurrent rows as one park entry (raw host memory where the arena
  refuses it); a resume that finds a piece gone recomputes by prefill
  (``_resume_cold``). Every host read is checksummed, and a circuit breaker
  turns a failing tier into misses.
* **Row-local chunked prefill** — an admitted row prefills its un-cached
  prompt tail through batch-1 windows over its own blocks, in power-of-two
  chunks of at most ``prefill_chunk``.
* **Round loop** — up to ``rounds_per_sync`` verify rounds run back to back
  on the device with on-device done masks, and the host pulls one packed
  (B, 5) int64 stats array per loop, ``[accepted, rounds_active,
  new_length, loop_rounds, bad]`` — the reference's ABI. Once no row is
  live the remaining rounds of the loop are no-ops (every row inactive),
  as the reference's ``lax.while_loop`` would have stopped there.
* **Adaptive speculation** — W is retuned per host sync from the accept
  EWMA (``AdaptiveWindowController``).
* **Learned forecasts** — ``use_forecast_heads`` fills the window slots
  past the fixed-point forecasts from the model's forecast (MTP) heads;
  forecasts gate acceptance only, so the tokens do not change.
* **Saturation** (the reference's DESIGN.md §12) — admission scans a
  bounded ``lookahead`` past an unroutable head, with an aging bound; a
  queued request of higher priority may **preempt** the lowest-priority
  running slots below a progress floor (``preempt``, ``preempt_floor``):
  a victim's live blocks, recurrent row, tokens and window are pulled to
  the host (one copy per dtype, ``ParkedSequence``), its blocks spilled
  (hashed prompt blocks stay hittable) and it is requeued at its original
  rank; its resume hits those blocks again, uploads the rest and restores
  ``tokens``/``n``/``cand``, so its tokens and its count of verify rounds
  equal an uninterrupted run's. Deadline expiries of queued and parked
  requests are counted at every step.
* **Staged adoption** (the reference's DESIGN.md §15) — with
  ``staging_slots > 0``, while every slot is busy, queued requests are
  staged into spare blocks (worst case claimed up front, through a
  ``StagingLedger``), and inside the round loop a row that finishes or
  goes bad adopts the next staged request with no host sync: its table
  row, prompt, noise stream and a forced-acceptance prefill at the verify
  width (``verify_round``'s ``prompt_len``). The loop is the reference's
  ``lax.while_loop`` as ``k`` device rounds with a sticky ``go`` flag that
  falls the first time the reference's condition would fail; the host
  pulls the (B, 7) stats, the displaced episodes and their token rows in
  one copy. ``adaptive_rounds`` retunes ``k`` from idle row-rounds
  (``RoundsPerSyncController``). With ``staging_slots == 0`` the loop and
  its (B, 5) stats are the unstaged ones above.
* **Fault isolation** (the reference's DESIGN.md §14) — the engine fails
  per request, never per process: submit-time validation rejects a
  malformed request with a ``RequestError``; a per-row health flag in the
  packed stats (non-finite logits, stuck progress) quarantines only its
  slot, whose blocks are released while every other row stays bitwise
  what it would have been; an allocation fault at admission or while a
  table grows fails only the request that hit it. Up to
  ``request_retries`` retries requeue a failed request at its original
  rank, a quarantined one on a fresh noise stream; ``cancel(uid)`` removes
  a queued, parked, staged or running request; ``max_request_seconds``
  and ``max_request_rounds`` bound runaways. A ``FaultPlan``
  (``serving/faults.py``; ``REPRO_FAULT_PLAN`` by default) scripts the
  faults: its ``alloc`` seam in ``BlockManager.alloc``, its host-tier
  seams (``arena_put``, ``arena_corrupt``, ``stage_drop``), its disk and
  journal seams (``disk_full``, ``disk_torn_write``, ``disk_slow``,
  ``journal_truncate``), and its poisoned noise streams, whose logits
  ``verify_round`` replaces with NaN.
* **Crash safety** (the reference's DESIGN.md §16; ``durable_dir``, None
  by default: a volatile engine) — under ``durable_dir`` the engine keeps
  a write-ahead request journal (``journal.wal``: every submit, admission,
  park, retry and outcome, fsynced every ``journal_fsync_every`` records
  and at every host sync), a scheduler checkpoint (``checkpoint.json``,
  written atomically at every host sync: each live request's clocks,
  rank and retries, each park's token row, window and prompt-block chain
  keys) and, unless ``disk_tier=False``, a disk tier below the host arena
  (``disk/``, ``disk_cache_mb``, 1024 MiB by default: the arena's spilled
  blocks and snapshots as crc-framed files, which a restarted engine hits
  again). ``restore()`` on a new engine over the same directory replays
  the journal, re-enqueues every accepted request that did not finish at
  its original rank (a checkpointed park as a cold park, rebuilt by
  prefill over what the disk still holds) and delivers journaled outcomes
  again. ``kill_point`` sites (``post_admit``, ``post_sync``, and in the
  journal and the disk tier ``pre_fsync`` and ``mid_spill``) let a test
  SIGKILL the process anywhere in that protocol.

* **Hot-path contracts** — under ``REPRO_CHECK_CONTRACTS=1`` the first
  dispatch of each round loop, staged loop and prefill variant runs under
  the op census against its named contract (``repro_torch.analysis``;
  ``contract_reports`` keeps the reports), and on the card every dispatch
  runs under ``set_sync_debug_mode("error")``. The loops read only device
  tensors: the host mirrors are uploaded before them
  (``_round_program``).

The pool and the per-slot row state (tokens, lengths, windows) are updated
in place: the reference donates them to each step, so their old values are
dead there too. ``donate=False`` copies the paged cache out of place at
every dispatch, as an undonated step writes a fresh pool.

Exactness: every request's tokens equal a per-request
``PredictiveSampler.generate`` run with the same noise key and stream id
(``Request.seq_id``), retried, preempted, adopted, restaged and
snapshot-resumed ones included, and so are those a restored engine
delivers after a crash (on the CPU bitwise; a restored park's re-prefill
rounds otherwise on the card, where it holds under the margin rule). A mesh
engine's tokens, migrated and rebalanced ones included, equal bitwise
those of the single-device engine whose calls carry the same rows: data D
at batch B against data 1 at batch B / D. At the same total batch a
matmul's rows may round otherwise (on the CPU as on the card), and tokens
agree under the margin rule.

* **Model axis** — on a ``(data, model)`` mesh with ``model > 1`` this
  process is one model rank: it holds its slice of the tensor-parallel
  parameters (``ServingTopology.place_params``) and a whole replica of each data shard's pool, and runs
  the same scheduler over the same requests as every other rank, the
  collectives inside each forward (``sharding/tensor_parallel.py``,
  ``sharding/moe_shard.py``) joining them. The host's decisions follow
  the tokens, so at every host sync the ranks compare a digest of the
  stats and of the accepted tokens and fail on a mismatch
  (``collectives.RankDivergence``). The engine reads one clock
  (``_now``): rank 0's ``time.monotonic()``, broadcast (8 bytes over the
  host group) as the engine is built, at each ``submit``, ``cancel``,
  ``restore`` and ``close``, and at the top of every ``step`` and again
  after its host sync; every rank decides deadlines,
  ``max_request_seconds`` and the checkpoint's clocks by it. Under ``durable_dir`` rank 0 alone owns ``journal.wal``
  and ``checkpoint.json``; each rank keeps its own disk tier
  (``durable_dir/disk`` on rank 0, ``durable_dir/rank{r}/disk`` on rank
  r), since each holds its own slice of the pool, and flushes its parks'
  prompt blocks there before the ranks agree on the snapshot and rank 0
  writes it. ``restore`` replays the journal and reads the checkpoint on
  rank 0 and broadcasts both; every rank rebuilds the same scheduler
  state from them, keeps only the disk entries every rank holds, and the
  ranks agree on a digest of that state. MLA and the recurrent mixers are
  refused there (ROADMAP item 20c).
"""
from __future__ import annotations

import functools
import json
import os
import struct
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import contracts_enabled, hot_path, maybe_check
from repro_torch.engine.spec_decode import GenState, make_eps_fn, verify_round
from repro_torch.models.transformer import (PagedView, TransformerLM,
                                            has_recurrent)
from repro_torch.serving.adaptive import (AdaptiveWindowController,
                                          RoundsPerSyncController)
from repro_torch.serving.admission import (AdmissionQueue, Request,
                                           StagedEntry,
                                           pack_staged_descriptors,
                                           pow2_at_most, prefill_chunks)
from repro_torch.serving.blocks import (ShardedBlockPool, StagingLedger,
                                       chain_hashes)
from repro_torch.serving.faults import (CircuitBreaker, FaultPlan,
                                        RequestError, StagingFault,
                                        kill_point)
from repro_torch.serving.hostcache import DiskTier, LeafLayout
from repro_torch.serving.journal import RequestJournal
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.topology import ServingTopology
from repro_torch.sharding import tensor_parallel as tp

# the host mirrors the round loops read, by their device-copy names
_MIRRORS = {"tables": "tables", "target": "target", "seq": "seq_ids",
            "poison": "poison", "plen": "plen"}


@dataclass
class ParkedSequence:
    """What the exact resume of a preempted slot needs, on the host: the
    accepted length ``n``, the token row and the verify window (the window
    gates only acceptance, and restoring it keeps even the count of verify
    rounds an uninterrupted run's), and the contents of the ``nb_live``
    leading blocks that hold positions ``[0, n - 1)`` and the slot's
    recurrent rows (position ``n - 1`` onward is rewritten by the next
    window, so later blocks need no copy).

    With a host tier the leading ``kv_keys`` blocks are shared prompt
    blocks pinned in the tier's ``kv`` namespace. The private rest, the
    ``n_rec`` recurrent row tensors then ``rows_per_block`` tensors for
    each later block, is the park entry ``("park", uid)`` (``in_arena``)
    or, without a tier or where the arena refused it, the raw host tensors
    in ``private``. A ``cold`` park is one a restore rebuilt from the
    checkpoint: no payload or pin of it exists in this process, and its
    resume prefills what the tiers do not hold."""
    n: int
    tokens: np.ndarray           # (max_len,) accepted-token row
    cand: np.ndarray             # (W_max,) verify-window snapshot
    nb_live: int                 # leading owned blocks whose contents matter
    kv_keys: tuple = ()          # tier-pinned chain keys of blocks [0, len)
    n_rec: int = 0               # leading private tensors: the recurrent row
    rows_per_block: int = 0      # private tensors per tail block
    in_arena: bool = False       # private part parked under ("park", uid)
    private: Optional[list] = None   # the private part, when not in the arena
    shard: int = 0               # the tier partition the pins live under
    cold: bool = False           # restored from a checkpoint: no payload


@dataclass
class _Shard:
    """One data shard's device state: its slots ``rows`` (a range of the
    batch), its device, the parameters and noise function it reads there,
    its paged cache (block sub-pool and recurrent rows), the ``tokens``,
    ``n`` and ``cand`` rows of its slots, its staging area (FIFO) and the
    device copies of its slots' host mirrors (``dev``, by ``_MIRRORS``
    name; a missing entry is uploaded before the next dispatch)."""
    index: int
    rows: range
    device: torch.device
    params: dict
    eps_fn: object
    paged: dict
    tokens: torch.Tensor
    n: torch.Tensor
    cand: torch.Tensor
    staged: list = field(default_factory=list)
    dev: dict = field(default_factory=dict)


def _params_on(tree, device):
    """``tree`` with every tensor on ``device`` (the tensors themselves
    where they are there already)."""
    if isinstance(tree, dict):
        return {k: _params_on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_params_on(v, device) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    # a placed leaf keeps its placement on the copy
    return tp.carry(tree, tree.to(device))


def _to_host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """``t`` on the host, in page-locked memory with ``pin``."""
    if not pin:
        return t.cpu()
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def pull_rows(leaves, idx, pin: bool) -> list:
    """Rows ``idx`` of each leaf on the host, for each row one flat tensor
    per dtype (the dtypes in the leaves' order of first appearance, each
    holding its leaves' rows in leaf order): one concatenation of the rows'
    views and one D2H copy per dtype, into page-locked memory with
    ``pin``."""
    groups = {}
    for leaf in leaves:
        groups.setdefault(leaf.dtype, []).append(leaf)
    host = [_to_host(torch.cat([leaf[int(i)].reshape(-1) for i in idx
                                for leaf in g]), pin).view(len(idx), -1)
            for g in groups.values()]
    return [[h[j] for h in host] for j in range(len(idx))]


def push_rows(leaves, idx, rows, device):
    """Write ``rows`` (``pull_rows``' encoding, on the host or on
    ``device``) into rows ``idx`` of each leaf: one H2D copy per dtype,
    then one index assignment into each leaf."""
    if not rows:
        return
    cols = {}
    for k, first in enumerate(rows[0]):
        col = (first.reshape(1, -1) if len(rows) == 1 else
               torch.stack([r[k] for r in rows]))
        cols[first.dtype] = col.to(device)
    gids = torch.as_tensor([int(i) for i in idx], dtype=torch.int64,
                           device=device)
    off = dict.fromkeys(cols, 0)
    for leaf in leaves:
        o, numel = off[leaf.dtype], leaf[0].numel()
        leaf[gids] = cols[leaf.dtype][:, o:o + numel].view(
            len(idx), *leaf.shape[1:])
        off[leaf.dtype] = o + numel


class ServingEngine:
    def __init__(self, cfg, params, *, batch: int, window_max: int = 8,
                 max_len: int = 256, eps_key=0, eps_fn=None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 adaptive: bool = True, window_init: int = 0,
                 prefix_cache: bool = True, prefill_chunk: int = 64,
                 use_forecast_heads: bool = False,
                 use_verify_kernel: bool = False,
                 paged_attention: bool = True,
                 use_attention_kernel: Optional[bool] = None,
                 topology: Optional[ServingTopology] = None,
                 rounds_per_sync: int = 4, lookahead: int = 8,
                 max_head_bypass: int = 16, preempt: bool = True,
                 preempt_floor: float = 0.75, rebalance: bool = True,
                 request_retries: int = 0,
                 max_request_seconds: Optional[float] = None,
                 max_request_rounds: Optional[int] = None,
                 faults: Optional[FaultPlan] = None,
                 staging_slots: int = 0,
                 adaptive_rounds: Optional[bool] = None,
                 host_cache_mb: Optional[float] = None, host_tier=None,
                 integrity_checks: bool = True,
                 host_prefetch: Optional[bool] = None,
                 prefetch_budget: int = 4,
                 durable_dir: Optional[str] = None,
                 journal_fsync_every: int = 1, disk_tier: bool = True,
                 disk_cache_mb: Optional[float] = None, donate: bool = True,
                 device=None):
        if block_size < 1 or window_max < 1 or rounds_per_sync < 1 \
                or prefill_chunk < 1 or lookahead < 1 or max_head_bypass < 0 \
                or request_retries < 0 or staging_slots < 0 \
                or prefetch_budget < 0 or journal_fsync_every < 1:
            raise ValueError("block_size, window_max, rounds_per_sync, "
                             "prefill_chunk, lookahead and "
                             "journal_fsync_every must be >= 1, "
                             "max_head_bypass, request_retries, "
                             "staging_slots and prefetch_budget >= 0")
        if not 0.0 <= preempt_floor <= 1.0:
            raise ValueError(f"preempt_floor={preempt_floor}, want [0, 1]")
        # the topology: slot ranges, block sub-pools and devices per data
        # shard; a mesh names its shards' devices itself
        self.topo = topology if topology is not None else ServingTopology()
        if self.topo.mesh is not None and device is not None:
            raise ValueError("a mesh topology names its devices; pass "
                             "device=None with it")
        # this process's rank of the model axis, None without one
        self.model_axis = self.topo.model_axis
        if self.model_axis is not None:
            self._check_model_axis(cfg)
            if not tp.is_placed(params):
                raise ValueError("a model axis serves this rank's slice of "
                                 "the parameters: pass topology."
                                 "place_params(cfg, params)")
        D = self.topo.data_size
        self.B_local = self.topo.slots_per_shard(batch)
        devices = [self.topo.device(s, device) for s in range(D)]
        self.device = devices[0]
        self.cfg = cfg
        self.params = params
        self.B = batch
        self.W_max = window_max
        self.max_len = max_len
        self.block_size = block_size
        self.prefill_chunk = pow2_at_most(prefill_chunk)
        self.use_forecast_heads = (use_forecast_heads
                                   and "forecast" in params
                                   and cfg.forecast_horizon > 0)
        self.use_verify_kernel = use_verify_kernel
        # decode through the block tables; False is the legacy dense round
        self.paged_attention = paged_attention
        # the fused paged kernel on the GPU; the gather-view fallback on the
        # CPU, which is exact against the dense solo sampler
        if use_attention_kernel is None:
            use_attention_kernel = all(d.type == "cuda" for d in devices)
        self.use_attention_kernel = use_attention_kernel
        self.rounds_per_sync = rounds_per_sync
        # staged adoption: up to ``staging_slots`` queued requests staged
        # for freed rows to adopt inside the round loop; ``adaptive_rounds``
        # (on by default with staging, and only allowed with it: its idle
        # signal exists only in the staged stats) retunes k
        self.staging_slots = staging_slots
        self.adaptive_rounds = (staging_slots > 0 if adaptive_rounds is None
                                else bool(adaptive_rounds)
                                and staging_slots > 0)
        self.rounds_ctrl = RoundsPerSyncController(
            k_max=rounds_per_sync, enabled=self.adaptive_rounds)
        # restage the host-resident prefix blocks of queued requests while
        # they wait (on by default with staging), at most
        # ``prefetch_budget`` blocks a step
        self.host_prefetch = (staging_slots > 0 if host_prefetch is None
                              else bool(host_prefetch))
        self.prefetch_budget = prefetch_budget
        self.lookahead = lookahead
        self.max_head_bypass = max_head_bypass
        # priority preemption, and the progress floor past which a running
        # slot is never evicted
        self.preempt = preempt
        self.preempt_floor = preempt_floor
        # cross-shard rebalancing by sequence migration at admission
        self.rebalance = rebalance
        self.request_retries = request_retries
        self.max_request_seconds = max_request_seconds
        self.max_request_rounds = max_request_rounds
        self.faults = faults if faults is not None else FaultPlan.from_env()
        # False: every dispatch copies the paged cache out of place first,
        # as an undonated round of the reference writes a fresh pool
        self.donate = donate
        # the Report of every dispatch checked under REPRO_CHECK_CONTRACTS
        self.contract_reports = []

        # ---- paged cache: one sub-pool and device state per shard -------
        self.nb = -(-(max_len + window_max) // block_size)  # table width
        if num_blocks is None:
            # per shard: full occupancy + slack so unreferenced prefix
            # blocks survive
            num_blocks = 1 + self.B_local * self.nb + 2 * self.nb
        # ``num_blocks`` is per data shard
        self.pool = ShardedBlockPool(D, num_blocks, block_size)
        if self.faults is not None:
            # the plan's bound method, not a closure over the engine (a
            # cycle through the block manager would outlive the engine)
            self.pool.set_fault_hook(functools.partial(self.faults.fire,
                                                       "alloc"))
        self.shards: list[_Shard] = []
        on_device, eps_on = {}, {}
        for s, dev in enumerate(devices):
            if dev not in on_device:
                on_device[dev] = _params_on(params, dev)
                eps_on[dev] = eps_fn if eps_fn is not None else make_eps_fn(
                    eps_key, cfg.vocab, device=dev)
            B_l = self.B_local
            self.shards.append(_Shard(
                index=s, rows=self.topo.slot_range(s, batch), device=dev,
                params=on_device[dev], eps_fn=eps_on[dev],
                paged=TransformerLM.init_paged_cache(
                    cfg, B_l, num_blocks, block_size, dtype=cfg.param_dtype,
                    device=dev),
                tokens=torch.zeros((B_l, max_len), dtype=torch.int64,
                                   device=dev),
                # the cleared-row sentinel n=1
                n=torch.ones((B_l,), dtype=torch.int64, device=dev),
                cand=torch.zeros((B_l, window_max), dtype=torch.int64,
                                 device=dev)))
        # block tables hold shard-local ids, each shard's sink local 0
        self.tables = np.zeros((batch, self.nb), np.int32)
        self.owned: list[list[int]] = [[] for _ in range(batch)]

        # ---- the clock --------------------------------------------------
        # on a model axis rank 0's reading, broadcast now and at every entry
        # point that reads it (``_tick``); ``time.monotonic()`` itself
        # without one
        self._clock = None
        self._tick()

        # ---- durability -------------------------------------------------
        # under ``durable_dir``: ``disk/`` (the tier below the arena),
        # ``journal.wal`` and ``checkpoint.json``; ``disk_tier=False`` keeps
        # the journal and the checkpoint but drops the spill to disk. On a
        # model axis the journal and the checkpoint are rank 0's, and rank
        # r > 0 keeps its disk tier under ``rank{r}/``
        self.durable_dir = durable_dir
        self.journal = None
        self._ckpt_path = None
        self.disk = None
        if durable_dir is not None:
            rank = self.topo.model_rank
            if disk_tier:
                dmb = 1024.0 if disk_cache_mb is None else float(disk_cache_mb)
                self.disk = DiskTier(
                    os.path.join(durable_dir, f"rank{rank}" if rank else "",
                                 "disk"),
                    int(dmb * 2 ** 20), faults=self.faults,
                    breaker=CircuitBreaker())
            if rank == 0:
                self.journal = RequestJournal(
                    os.path.join(durable_dir, "journal.wal"),
                    fsync_every=journal_fsync_every, faults=self.faults)
                self._ckpt_path = os.path.join(durable_dir, "checkpoint.json")

        # ---- host cache tier --------------------------------------------
        if host_tier is not None:
            # a tier staging to another device, or an arena pinned for
            # another, would copy through the wrong path unnoticed
            cuda = any(d.type == "cuda" for d in devices)
            if (host_tier.num_shards != D
                    or host_tier.arena.pinned != cuda
                    or any(host_tier.staging_for(s).device.type != d.type
                           for s, d in enumerate(devices))):
                raise ValueError(
                    f"host_tier stages to {host_tier.devices} (arena "
                    f"pinned={host_tier.arena.pinned}); the engine's shards "
                    f"run on {devices}")
            self.tier = host_tier
        else:
            mb = host_cache_mb
            if mb is None:
                mb = float(os.environ.get("REPRO_HOST_CACHE_MB", 256))
            self.tier = (self.topo.host_tier(
                int(mb * 2 ** 20), integrity=integrity_checks,
                faults=self.faults, breaker=CircuitBreaker(), disk=self.disk,
                device=device) if mb > 0 else None)
        paged0 = self.shards[0].paged
        if self.tier is not None and self.tier.disk is not None:
            # entries on disk in the reference's layout (one array per leaf
            # of its tree), the dtypes restored from these on the way back
            for ns, kind, leaves in (
                    ("kv", "pool", TransformerLM.pool_leaves(cfg, paged0)),
                    ("rec", "state", TransformerLM.state_leaves(cfg, paged0))):
                self.tier.set_layout(ns, LeafLayout.of(
                    leaves, TransformerLM.reference_walk(cfg, paged0, kind)))
        # the prefix cache per state kind: paged KV blocks are shareable
        # (``kv_prefix``); a recurrent stack's state after a prefix is not
        # paged, so its prefix hits go through the tier's snapshots
        # (``rec_prefix``), a hybrid's KV blocks beside them (``_kv_share``)
        self.recurrent = has_recurrent(cfg)
        self.has_attn = bool(TransformerLM.pool_leaves(cfg, paged0))
        self.kv_prefix = prefix_cache and not self.recurrent
        self.rec_prefix = (prefix_cache and self.recurrent
                           and self.tier is not None)
        self._kv_share = self.kv_prefix or (self.rec_prefix and self.has_attn)
        # host copies are page-locked for the tier's uploads; a tier-less
        # park stays in pageable memory
        self._pin_host = self.tier is not None and self.tier.arena.pinned
        self.pool.set_spill_hook(self._make_spill_hook)

        # ---- control / telemetry ---------------------------------------
        self.controller = AdaptiveWindowController(
            w_max=window_max, w_init=window_init, enabled=adaptive)
        self.metrics = EngineMetrics()
        self.queue = AdmissionQueue()
        self.slots: list[Optional[Request]] = [None] * batch
        self.done: list[Request] = []
        self.target = np.zeros(batch, np.int64)
        # worst-case block need reserved per slot at admission (run-to-
        # completion: lazy table growth may never exhaust the pool)
        self.reserved = np.zeros(batch, np.int64)
        # host mirror of each slot's accepted length, from the stats of
        # every sync (the progress floor and parking read it)
        self.n_host = np.ones(batch, np.int64)
        # preempted requests by uid, awaiting their exact resume
        self.parked: dict[int, ParkedSequence] = {}
        self._last_rounds_exec = 0
        # the ledger of the staging areas' block claims (each shard's
        # area, FIFO, is its ``staged``)
        self.ledger = StagingLedger(staging_slots)
        # queued requests' prefetched prefix blocks on a shard's device, by
        # uid: (shard, {chain key: that block's rows})
        self._prefetched: dict[int, tuple] = {}

        # ---- host mirrors of the per-slot state ----------------------------
        self.seq_ids = np.zeros(batch, np.int64)
        # 1 where the slot's noise stream is one of the fault plan's
        # poisoned streams: its logits are NaN-replaced every round
        self.poison = np.zeros(batch, np.int64)
        # each slot's prompt length: only a row adopted inside the staged
        # loop is ever at n < plen (its forced-acceptance prefill)
        self.plen = np.zeros(batch, np.int64)

    @staticmethod
    def _check_model_axis(cfg):
        """What the model axis does not serve yet raises here."""
        other = sorted({m for m, f in cfg.layer_specs()
                        if m not in ("attn", "local")}
                       | {f for m, f in cfg.layer_specs()
                          if f not in ("dense", "moe")})
        if other:
            raise NotImplementedError(
                f"{cfg.name}: {other} on a model axis is ROADMAP item 20c")

    # -- the clock ------------------------------------------------------------
    def _tick(self):
        """On a model axis, rank 0's ``time.monotonic()`` broadcast to every
        rank (one 8-byte host broadcast): the reading ``_now`` returns
        until the next tick. Nothing without one. Every rank calls the
        engine's entry points in lockstep, so each entry point that reads
        the clock ticks first: ``submit``, ``cancel``, ``restore``,
        ``close``, and ``step`` at its top and after its host sync."""
        if self.model_axis is None:
            return
        axis = self.model_axis
        mine = struct.pack("<d", time.monotonic()) if axis.rank == 0 else None
        self._clock = struct.unpack("<d", axis.broadcast_bytes(
            mine, src=0, size=8))[0]

    def _now(self) -> float:
        """The engine's clock: ``time.monotonic()``, or on a model axis the
        reading of the last ``_tick``, so that every rank makes each
        wall-clock decision alike."""
        return time.monotonic() if self.model_axis is None else self._clock

    # -- shards -----------------------------------------------------------
    def _shard_of(self, b: int) -> _Shard:
        """The shard that owns slot ``b``."""
        return self.shards[self.topo.shard_of_slot(b, self.B)]

    def _local(self, b: int) -> tuple:
        """Slot ``b``'s shard and its row there."""
        sh = self._shard_of(b)
        return sh, b - sh.rows.start

    def _mgr(self, b: int):
        """The block manager of the shard that owns slot ``b``."""
        return self.pool.manager(self._shard_of(b).index)

    def _stale(self, b: int, *names):
        """Drop slot ``b``'s shard's device copies of the host mirrors
        ``names`` (``_MIRRORS`` keys; all of them by default): they are
        uploaded again before the next dispatch."""
        dev = self._shard_of(b).dev
        for name in names or _MIRRORS:
            dev.pop(name, None)

    def _mirror_device(self, sh: _Shard, name: str):
        """Shard ``sh``'s device copy of host mirror ``name``."""
        if name not in sh.dev:
            host = getattr(self, _MIRRORS[name])[sh.rows.start:sh.rows.stop]
            sh.dev[name] = torch.from_numpy(host.copy()).to(sh.device)
        return sh.dev[name]

    def _single(self, name: str):
        """The one shard's ``name`` (its live tensor); a mesh engine has no
        single one: read ``shards[s].<name>``."""
        if len(self.shards) != 1:
            raise AttributeError(
                f"a {len(self.shards)}-shard engine keeps {name!r} per "
                f"shard: read shards[s].{name}")
        return getattr(self.shards[0], name)

    @property
    def tokens(self):
        return self._single("tokens")

    @property
    def n(self):
        return self._single("n")

    @property
    def cand(self):
        return self._single("cand")

    @property
    def paged(self):
        return self._single("paged")

    @property
    def staged(self) -> list:
        """Every staged entry, shard-major, FIFO within a shard."""
        return [e for sh in self.shards for e in sh.staged]

    @property
    def state(self):
        """The seed ``ContinuousBatcher``'s ``state.rounds``, ``n`` and
        ``tokens``."""
        return SimpleNamespace(rounds=self.metrics.rounds, n=self.n,
                               tokens=self.tokens)

    # -- submission ---------------------------------------------------------
    def _validate(self, req: Request) -> Optional[RequestError]:
        prompt = np.asarray(req.prompt)
        if prompt.size < 1:
            return RequestError("empty_prompt", "prompt holds no tokens")
        if req.new_tokens <= 0:
            return RequestError("bad_new_tokens",
                                f"new_tokens={req.new_tokens}")
        if prompt.size + req.new_tokens > self.max_len:
            return RequestError(
                "too_long", f"{prompt.size} prompt + {req.new_tokens} new "
                f"> max_len={self.max_len}")
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self.cfg.vocab:
            return RequestError(
                "token_out_of_range",
                f"tokens span [{lo}, {hi}], vocab={self.cfg.vocab}")
        cap = self.pool.blocks_per_shard - 1     # minus the reserved sink
        if self._worst_case_blocks(req) > cap:
            return RequestError(
                "over_capacity", f"worst case {self._worst_case_blocks(req)}"
                f" blocks > pool capacity {cap}/shard")
        return None

    def submit(self, req: Request) -> bool:
        """Validate and enqueue. Returns False — with ``req.error`` set and
        the request delivered through ``done`` — on rejection."""
        self._tick()
        err = self._validate(req)
        if err is not None:
            req.error = err
            req.submit_time = self._now()
            req.finish_time = req.submit_time
            self.metrics.requests_rejected += 1
            self.done.append(req)
            return False
        self.queue.push(req, self._now())
        # journaled after the push, which pinned the arrival rank; with
        # ``journal_fsync_every=1`` the submit is on media before this
        # returns, so an accepted request survives any later crash
        if self.journal is not None:
            self.journal.append(
                "submit", uid=int(req.uid),
                prompt=[int(t) for t in np.asarray(req.prompt).ravel()],
                new_tokens=int(req.new_tokens), priority=int(req.priority),
                deadline=req.deadline, noise_seed=req.noise_seed,
                rank=int(req._seq))
        return True

    def _journal(self, type: str, **fields):
        """Append one lifecycle record to the journal, if there is one."""
        if self.journal is not None:
            self.journal.append(type, **fields)

    def _journal_finish(self, req: Request):
        """Journal ``req``'s delivered tokens; a volatile engine builds no
        record."""
        if self.journal is not None:
            self.journal.append("finish", uid=int(req.uid),
                                tokens=[int(t) for t in req.result])

    # -- device steps -------------------------------------------------------
    def _prefill(self, table_row, b: int, chunk, start: int):
        """Row-local prefill of one chunk through slot ``b``'s block table,
        through the contract seam: its start uploaded before the checked
        region (``_prefill_chunk``), as the chunk and the table row were."""
        sh = self._shard_of(b)
        start_t = torch.tensor([start], dtype=torch.int32, device=sh.device)
        self._contract_check(
            "prefill", functools.partial(self._prefill_chunk, b=b),
            (table_row, chunk, start_t), shards=(sh.index,))

    def _prefill_chunk(self, table_row, chunk, start_t, *, b: int):
        """Row-local prefill of one chunk through slot ``b``'s block table
        (shard-local ids) from position ``start_t`` (1,), on slot ``b``'s
        shard; its pool is written in place and the slot's recurrent row
        takes the state after the chunk's last token."""
        sh, r = self._local(b)
        rows = slice(r, r + 1)
        if not self.paged_attention:
            view = TransformerLM.gather_paged(self.cfg, sh.paged, table_row,
                                              rows)
            _, _, nc = TransformerLM.decode_window(
                sh.params, self.cfg, chunk, view, start_t,
                use_kernel=self.use_attention_kernel, last_state_only=True)
            TransformerLM.scatter_paged(
                self.cfg, sh.paged, nc, table_row, rows, start_t,
                chunk.shape[1], torch.ones((1,), dtype=torch.int32,
                                           device=sh.device))
            return
        view = PagedView(table_row, rows, self.use_attention_kernel)
        _, _, nc = TransformerLM.decode_window_paged(
            sh.params, self.cfg, chunk, sh.paged, view, start_t,
            last_state_only=True)
        TransformerLM.adopt_states_paged(self.cfg, sh.paged, nc, view.rows)

    def _verify(self, sh: _Shard, tables, st: GenState, tgt, W: int, poison,
                prompt_len=None):
        """One verify round of shard ``sh``'s rows over its pool, in place:
        through the block tables, or in the legacy dense round by a view
        gathered through them, decoded, and its window written back (rows
        inactive under ``tgt`` write nothing)."""
        B = self.B_local
        if self.paged_attention:
            view = PagedView(tables, slice(0, B), self.use_attention_kernel)
            return verify_round(
                sh.params, self.cfg, sh.eps_fn, st, tgt,
                use_forecast_heads=self.use_forecast_heads,
                use_verify_kernel=self.use_verify_kernel, paged=view,
                poison=poison, prompt_len=prompt_len)
        dense = TransformerLM.gather_paged(self.cfg, sh.paged, tables,
                                           slice(0, B))
        st2, rstats = verify_round(
            sh.params, self.cfg, sh.eps_fn, st._replace(cache=dense), tgt,
            use_forecast_heads=self.use_forecast_heads,
            use_verify_kernel=self.use_verify_kernel,
            use_attention_kernel=self.use_attention_kernel, poison=poison,
            prompt_len=prompt_len)
        TransformerLM.scatter_paged(self.cfg, sh.paged, st2.cache, tables,
                                    slice(0, B), (st.n - 1).clamp(min=0), W,
                                    st.n < tgt)
        return st2, rstats

    @hot_path
    def _round_loop(self, W: int, tables, seq_ids, target, poison, *,
                    k: int, s: int) -> torch.Tensor:
        """Up to ``k`` verify rounds at window W of shard ``s``'s rows on
        its device, with no host sync inside: the loop reads device tensors
        only, the block tables, stream ids, targets and poison flags
        uploaded before it (``_round_program``) as the reference's jitted
        round takes them as arguments. ``poison`` is None where no slot
        holds a poisoned stream: every row's logits then pass through
        untouched, so the select over them is left out. A round runs while
        some row of the shard is live (not done, not bad); after that every
        round is a no-op (its target is zeroed, so no row is active), the
        work the reference's ``while_loop`` skips. Returns the shard's
        packed (B_local, 5) stats ``[accepted, rounds_active, new_length,
        loop_rounds, bad]``."""
        sh = self.shards[s]
        B, dev = self.B_local, sh.device
        tokens, n, cand = sh.tokens, sh.n, sh.cand
        zero = torch.zeros((B,), dtype=torch.int64, device=dev)
        acc, act_rounds, bad = zero, zero, zero
        r = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(k):
            live = ((n < target) & (bad == 0)).any()
            tgt = torch.where(live, target, zero)
            active = (n < tgt).long()
            st = GenState(tokens, n, cand[:, :W], sh.paged, r, zero, zero,
                          seq_ids)
            st2, rstats = self._verify(sh, tables, st, tgt, W, poison)
            # sticky health bits: 1 = non-finite logits, 2 = no progress
            stuck = active * (st2.n == n).long()
            bad = bad | (active * rstats[:, 3]) | (stuck << 1)
            acc = acc + rstats[:, 0]
            act_rounds = act_rounds + active
            r = r + live.long()
            self.metrics.verify_passes += 1
            tokens, n = st2.tokens, st2.n
            cand = torch.cat([st2.cand, torch.zeros_like(cand[:, W:])], dim=1)
        sh.tokens.copy_(tokens)
        sh.n.copy_(n)
        sh.cand.copy_(cand)
        return torch.stack([acc, act_rounds, n, r.expand(B), bad], dim=1)

    @hot_path
    def _staged_loop(self, W: int, use_poison: bool, tables, seq, target,
                     poison_c, plen, staged, *, k: int,
                     s: int) -> torch.Tensor:
        """Shard ``s``'s round loop with in-loop adoption (``staging_slots
        > 0``) from its own staging area: the reference's staged
        ``while_loop`` as ``k`` device rounds. A sticky
        ``go`` flag falls the first time the reference's condition fails —
        no row live and no descriptor left, or (while the host holds more
        backlog) a freed row with the staging area drained after the first
        round — and from then on no row adopts, no idle row-round is
        counted, ``r`` stops and the rounds run with a zeroed target.

        Each live round opens with the adoption scan: rows done or bad take
        the next staged descriptors in FIFO order (row order breaks ties),
        their displaced episode ``[row, n, accepted, rounds_active, bad,
        gen_rounds]`` and token row kept by descriptor; an adopted row gets
        the descriptor's table row, prompt, stream, target, poison and
        prompt length, a window of its prompt tokens and zeroed recurrent
        rows, and its verify rounds prefill it by forced acceptance.
        Dropped writes go to an extra descriptor row that is cut off.

        The loop reads device tensors only, uploaded before it
        (``_round_program``): the tables, stream ids, targets, poison flags
        and prompt lengths, and ``staged``, the staging area
        (``_staged_args``: the descriptors, their count and whether the
        host holds more backlog). ``use_poison`` says whether a slot or a
        descriptor holds a poisoned stream, else the select is left out.

        Returns one int64 buffer for the single pull: the (B_local, 7)
        stats ``[accepted, rounds_active, new_length, loop_rounds, bad,
        gen_rounds, idle_rounds]``, then (S, 6) episodes (-1 rows: not
        adopted; rows local to the shard), then (S, max_len) token rows.
        The updated tables, stream ids, targets, poison and prompt lengths
        become the shard's device copies; the host mirrors follow in
        ``_harvest_adoptions``."""
        sh = self.shards[s]
        B, dev, S = self.B_local, sh.device, self.staging_slots
        max_len, Wm = self.max_len, self.W_max
        (d_tables, d_tokens, d_n, d_target, d_seq, d_poison, d_plen, count,
         q_more) = staged
        tokens, n, cand = sh.tokens, sh.n, sh.cand
        states = (TransformerLM.state_leaves(self.cfg, sh.paged)
                  if self.recurrent else [])
        zero = torch.zeros((B,), dtype=torch.int64, device=dev)
        acc = act = bad = gen = idle = zero
        m = torch.zeros((), dtype=torch.int64, device=dev)
        r = torch.zeros((), dtype=torch.int64, device=dev)
        go = torch.ones((), dtype=torch.bool, device=dev)
        astats = torch.full((S + 1, 6), -1, dtype=torch.int64, device=dev)
        otok = torch.zeros((S + 1, max_len), dtype=torch.int64, device=dev)
        rows = torch.arange(B, device=dev)
        slots_w = torch.arange(Wm, device=dev)[None, :]
        for _ in range(k):
            free = (n >= target) | (bad > 0)
            cont = ((n < target) & (bad == 0)).any() | (m < count)
            cont = cont & ~(q_more & (m >= count) & free.any() & (r > 0))
            go = go & cont
            # ---- adoption scan ------------------------------------------
            free = free & go
            desc = m + torch.cumsum(free.long(), 0) - 1
            take = free & (desc < count)
            di = torch.where(take, desc, S)
            otok[di] = tokens
            astats[di] = torch.stack([rows, n, acc, act, bad, gen], dim=1)
            src = desc.clamp(0, S - 1)
            tk = take[:, None]
            tokens = torch.where(tk, d_tokens[src], tokens)
            tables = torch.where(tk, d_tables[src], tables)
            n = torch.where(take, d_n[src], n)
            seq = torch.where(take, d_seq[src], seq)
            target = torch.where(take, d_target[src], target)
            poison_c = torch.where(take, d_poison[src], poison_c)
            plen = torch.where(take, d_plen[src], plen)
            # the adopted window: slots on the prompt carry its tokens
            p = (d_n[src] - 1)[:, None] + slots_w
            ptok = torch.gather(d_tokens[src], 1, p.clamp(0, max_len - 1))
            a_cand = torch.where((p <= (d_plen[src] - 1)[:, None])
                                 & (slots_w < W), ptok, 0)
            cand = torch.where(tk, a_cand, cand)
            acc, act, bad, gen = (torch.where(take, 0, x)
                                  for x in (acc, act, bad, gen))
            idle = idle + (free & ~take).long()
            m = m + take.long().sum()
            for leaf in states:
                leaf.masked_fill_(take.view((B,) + (1,) * (leaf.ndim - 1)),
                                  0)
            # ---- verify round -------------------------------------------
            tgt = torch.where(go, target, zero)
            active = (n < tgt).long()
            # a round adopts every row's recurrent state, an inactive row's
            # one token past its snapshot: rows a fallen ``go`` froze while
            # live keep theirs
            snaps = [leaf.clone() for leaf in states]
            st = GenState(tokens, n, cand[:, :W], sh.paged, r, zero, zero,
                          seq)
            st2, rstats = self._verify(sh, tables, st, tgt, W,
                                       poison_c if use_poison else None,
                                       prompt_len=plen)
            for leaf, snap in zip(states, snaps):
                keep = active.bool().view((B,) + (1,) * (leaf.ndim - 1))
                leaf.copy_(torch.where(keep, leaf, snap))
            stuck = active * (st2.n == n).long()
            bad = bad | (active * rstats[:, 3]) | (stuck << 1)
            # generated tokens only: forced prompt accepts are prefill
            acc = acc + (st2.n - torch.maximum(n, plen)).clamp(min=0)
            act = act + active
            gen = gen + active * (st2.n > plen).long()
            r = r + go.long()
            self.metrics.verify_passes += 1
            tokens, n = st2.tokens, st2.n
            cand = torch.cat([st2.cand, torch.zeros_like(cand[:, W:])], dim=1)
        sh.tokens.copy_(tokens)
        sh.n.copy_(n)
        sh.cand.copy_(cand)
        sh.dev.update(tables=tables, seq=seq, target=target, poison=poison_c,
                      plen=plen)
        stats = torch.stack([acc, act, n, r.expand(B), bad, gen, idle], dim=1)
        return torch.cat([stats.reshape(-1), astats[:S].reshape(-1),
                          otok[:S].reshape(-1)])

    def _staged_args(self, sh: _Shard) -> tuple:
        """Shard ``sh``'s staging area on its device, with one upload: the
        descriptors' tables (int32), tokens, start lengths, targets,
        streams, poison and prompt lengths (int64), then their count and
        whether the host holds more backlog (() int64 and bool; the same
        flag for every shard, as admission routes globally)."""
        _, tables, tokens, n0, target, seq, poison, plen = \
            pack_staged_descriptors([sh.staged], self.staging_slots,
                                    self.nb, self.max_len)
        parts = (tables, tokens, n0, target, seq, poison, plen,
                 np.array(len(sh.staged)), np.array(len(self.queue) > 0))
        flat = torch.from_numpy(np.concatenate(
            [a.astype(np.int64).reshape(-1) for a in parts])).to(sh.device)
        out, off = [], 0
        for a in parts:
            out.append(flat[off:off + a.size].view(a.shape))
            off += a.size
        out[0] = out[0].to(torch.int32)
        out[-1] = out[-1].bool()
        return tuple(out)

    def _round_program(self, W: int, k: int, s: int = 0) -> tuple:
        """``(kind, fn, args)`` of shard ``s``'s round loop the next step
        dispatches at window W and ``k`` rounds: the shard's host mirrors
        uploaded here, so the loop itself reads only device tensors.
        ``args`` holds what sets the program's shapes (W, the poison
        select) beside the tensors; ``k`` and ``s`` are bound in ``fn``: a
        loop of k rounds replays one round's program k times."""
        sh = self.shards[s]
        mirror = functools.partial(self._mirror_device, sh)
        tables, seq, target = mirror("tables"), mirror("seq"), mirror("target")
        poisoned = bool(self.poison[sh.rows.start:sh.rows.stop].any())
        if self.staging_slots == 0:
            return ("round", functools.partial(self._round_loop, k=k, s=s),
                    (W, tables, seq, target,
                     mirror("poison") if poisoned else None))
        use_poison = poisoned or any(e.poison for e in sh.staged)
        return ("staged_round",
                functools.partial(self._staged_loop, k=k, s=s),
                (W, use_poison, tables, seq, target, mirror("poison"),
                 mirror("plen"), self._staged_args(sh)))

    def _paged_leaves(self, shards=(0,)) -> dict:
        """Every tensor of the paged caches of ``shards``: ``pool``, the
        block pools, and ``state``, the recurrent state rows."""
        caches = [self.shards[s].paged for s in shards]
        return {"pool": [x for c in caches
                         for x in TransformerLM.pool_leaves(self.cfg, c)],
                "state": [x for c in caches
                          for x in TransformerLM.state_leaves(self.cfg, c)]}

    def _contract_check(self, kind: str, fn, args, *, shards=(0,),
                        variant=None):
        """The contract seam: ``fn(*args)``, a program over the paged
        caches of ``shards``, checked against its named contract at its
        first dispatch under ``REPRO_CHECK_CONTRACTS=1``
        (``analysis.maybe_check``; on the card every dispatch then runs
        under ``set_sync_debug_mode("error")``). The label is per engine
        and shard, so the recompile registry never mixes instances and
        every shard's dispatch is checked; an engine built with
        ``donate=False`` copies the caches out of place first and skips
        the aliasing rule."""
        leaves = self._paged_leaves(shards)
        if not self.donate:
            fn = functools.partial(self._undonated, fn, shards=shards)
        if not contracts_enabled():
            return fn(*args)
        label = f"{kind}@{hex(id(self))}:" + ",".join(map(str, shards))
        return maybe_check(kind, fn, args, label=label, variant=variant,
                           donate=self.donate,
                           device=self.shards[shards[-1]].device,
                           reports=self.contract_reports, **leaves,
                           **self._contract_exemptions())

    def _undonated(self, fn, *args, shards=(0,)):
        """``fn(*args)`` as an undonated program of the reference runs:
        every leaf of the paged caches of ``shards`` is first copied out
        of place, the copy taking the leaf's place (``set_``,
        so everything holding the leaf sees it) and the old storage freed.
        Tokens are unchanged; the cost is one read and one write of the
        cache per dispatch; leaf by leaf, so beside the cache one leaf's
        copy is live, not a second cache as in the reference's undonated
        program."""
        leaves = self._paged_leaves(shards)
        for leaf in leaves["pool"] + leaves["state"]:
            leaf.set_(leaf.clone())
        return fn(*args)

    def _contract_exemptions(self) -> dict:
        """This engine's refinement of the contracts (consumed by
        ``maybe_check`` / ``check_engine_round``): ``pool_scatter_shapes``,
        the exact KV-pool leaf shapes (a shard's, the same on every shard),
        narrows NoPoolRankedScatters from the rank proxy to real pool
        writes (MoE dispatch buffers and recurrent state rows are high-rank
        scatters the round runs by design); ``tensor_parallel`` on a model
        axis allows the collectives of that axis (a data-axis one still
        fails)."""
        return {"pool_scatter_shapes": frozenset(
            tuple(leaf.shape) for leaf in TransformerLM.pool_leaves(
                self.cfg, self.shards[0].paged)),
            "tensor_parallel": self.model_axis is not None}

    def _agree(self, busy, outs):
        """The model ranks' agreement at a host sync: a digest of every
        busy shard's stats and of its token rows (each row's tokens summed
        against their positions, on the device) compared across the axis;
        ``sharding.collectives.RankDivergence`` on a mismatch."""
        parts = [torch.cat([out.reshape(-1), (sh.tokens * torch.arange(
            1, self.max_len + 1, device=sh.device)).sum(dim=1)]).cpu()
            for sh, out in zip(busy, outs)]
        self.model_axis.agree(torch.cat(parts).numpy().tobytes(),
                              f"host sync {self.metrics.host_syncs}")

    # -- slot / block plumbing ---------------------------------------------
    def _ensure_capacity(self, b: int, upto_pos: int):
        """Grow slot ``b``'s block table to cover positions [0, upto_pos)."""
        need = -(-upto_pos // self.block_size)
        assert need <= self.nb, (need, self.nb)
        mgr = self._mgr(b)
        while len(self.owned[b]) < need:
            blk = mgr.alloc(1)[0]
            self.tables[b, len(self.owned[b])] = blk
            self.owned[b].append(blk)
            self._stale(b, "tables")

    def _grow_run(self, b: int, pos0: int, n: int) -> list:
        """Slot ``b``'s table grown to ``pos0 + n`` blocks; the ids at
        positions ``[pos0, pos0 + n)``."""
        self._ensure_capacity(b, (pos0 + n) * self.block_size)
        return self.owned[b][pos0:pos0 + n]

    def _clear_row(self, b: int, release: bool = True):
        """Reset slot ``b`` to the inactive no-op lane: n=1, cache_len=0,
        an all-zero table (sink block 0), zeroed recurrent rows.
        ``release=False`` leaves the block accounting alone (a preempted
        slot's blocks were spilled already, a migrated one's moved)."""
        if release:
            self._mgr(b).release_all(self.owned[b])
        self.owned[b] = []
        self.tables[b] = 0
        self.target[b] = 0
        self.reserved[b] = 0
        self.n_host[b] = 1
        self.seq_ids[b] = 0
        self.poison[b] = 0
        self.plen[b] = 0
        self._stale(b)
        sh, r = self._local(b)
        sh.tokens[r] = 0
        sh.n[r] = 1
        sh.cand[r] = 0
        TransformerLM.reset_rows(self.cfg, sh.paged, r)

    def _set_poison(self, b: int, req: Request):
        """Slot ``b``'s poison entry for its new occupant."""
        v = int(self._poisoned(req))
        if int(self.poison[b]) != v:
            self.poison[b] = v
            self._stale(b, "poison")

    def _poisoned(self, req: Request) -> bool:
        return (self.faults is not None
                and req.seq_id in self.faults.poison_streams)

    def _occupy(self, b: int, req: Request, L_p: int):
        """Slot ``b``'s host state for its new occupant ``req``."""
        self.slots[b] = req
        self._set_poison(b, req)
        self.target[b] = L_p + req.new_tokens
        self._stale(b, "target")
        if self.plen[b] != L_p:
            self.plen[b] = L_p
            self._stale(b, "plen")
        self.reserved[b] = self._worst_case_blocks(req)

    # -- host tier plumbing ----------------------------------------------------
    def _collect_block_payload(self, gids, s: int = 0) -> list:
        """The pool rows of shard ``s``'s blocks ``gids`` on the host, per
        block its flat tensors (one per dtype), with one D2H copy per
        dtype."""
        if len(gids) == 0:
            return []
        return pull_rows(
            TransformerLM.pool_leaves(self.cfg, self.shards[s].paged), gids,
            self._pin_host)

    def _merge_block_rows(self, gids, rows, s: int = 0):
        """Write blocks' rows (``_collect_block_payload``'s encoding, one
        entry per block of ``gids``) into shard ``s``'s pool; the
        reference's ``.at[gid].set`` merge is an index assignment here
        too."""
        sh = self.shards[s]
        push_rows(TransformerLM.pool_leaves(self.cfg, sh.paged), gids, rows,
                  sh.device)

    def _collect_rec_row(self, b: int) -> list:
        """Slot ``b``'s recurrent state rows on the host (one flat tensor
        per dtype)."""
        sh, r = self._local(b)
        return pull_rows(TransformerLM.state_leaves(self.cfg, sh.paged),
                         [r], self._pin_host)[0]

    def _restore_rec_row(self, b: int, rows):
        sh, r = self._local(b)
        push_rows(TransformerLM.state_leaves(self.cfg, sh.paged), [r],
                  [rows], sh.device)

    def _make_spill_hook(self, s: int):
        """Shard ``s``'s eviction hook: a hashed cached-free block about to
        be reclaimed is copied into the tier under the shard's key space
        and its chain key (no copy when the key is resident already: keys
        are content-addressed). None (dropped outright) without a tier or
        attention pools. The hook holds the tier and the pool tensors, not
        the engine: the engine holds the block manager that holds the
        hook, and a cycle would keep the device pools alive until a
        garbage collection."""
        if self.tier is None or not self.has_attn:
            return None
        tier = self.tier
        leaves = TransformerLM.pool_leaves(self.cfg, self.shards[s].paged)
        pin = self._pin_host

        def hook(bid: int, key) -> bool:
            if tier.has_kv(s, key):
                return True
            return tier.put_kv(s, key, pull_rows(leaves, [bid], pin)[0])
        return hook

    def _stage_host_blocks(self, host_keys, blocks_for, s: int,
                           prefetched: Optional[dict] = None) -> int:
        """Restage shard ``s``'s tier-resident KV blocks into the blocks
        that ``blocks_for(n)`` allocates (or names) for the first ``n``
        keys. The run is pinned before those allocations, whose evictions
        spill into the same arena, so they cannot evict it; a pin that
        fails cuts the run, and prefill covers the rest. Keys in
        ``prefetched`` have a device copy already and need no pin. Returns
        the number of blocks restaged."""
        pinned = []
        for key in host_keys:
            if prefetched is not None and key in prefetched:
                pinned.append(key)
                continue
            if not self.tier.pin_kv(s, key):
                break
            pinned.append(key)
        try:
            return self._restage_host_blocks(
                pinned, blocks_for(len(pinned)), s, prefetched=prefetched)
        finally:
            for key in pinned:
                if prefetched is None or key not in prefetched:
                    self.tier.unpin_kv(s, key)

    def _through_ring(self, uploads, ring):
        """Push ``uploads``, ``(tag, tensors, on_device)`` items, through
        staging ``ring`` with ``depth`` uploads in flight, and yield
        ``(tag, device tensors)`` in their order; an ``on_device`` item
        (a device copy already) passes through once the ring has
        drained."""
        for tag, tensors, on_device in uploads:
            if on_device:
                while (item := ring.take()) is not None:
                    yield item
                yield tag, tensors
                continue
            ring.stage(tag, tensors)
            if len(ring) >= ring.depth:
                yield ring.take()
        while (item := ring.take()) is not None:
            yield item

    def _staging_failed(self, ring):
        """A run through ``ring`` died: drop its uploads and count it."""
        ring.clear()
        self.metrics.staging_errors += 1
        self.tier.record_failure()

    def _restage_host_blocks(self, host_keys, block_ids, s: int,
                             prefetched: Optional[dict] = None) -> int:
        """Merge shard ``s``'s tier entries under ``host_keys`` into its
        allocated ``block_ids`` (1:1, in key order) through the shard's
        staging ring, each merged block registered; ``depth`` uploads are
        in flight while earlier ones merge. Prefetched device rows merge
        directly (``prefetch_hits``), after the ring drains, so the merged
        blocks are always a prefix in key order. A run that dies (a
        ``StagingFault``) clears the ring and counts only what merged:
        prefill rewrites the rest. Returns the number of blocks merged."""
        def uploads():
            for gid, key in zip(block_ids, host_keys):
                if prefetched is not None and key in prefetched:
                    yield (gid, key, True), prefetched[key], True
                    continue
                rows = self.tier.get_kv(s, key)      # counts the host hit
                if rows is None:     # corrupt, or the tier tripped: cut
                    return
                yield (gid, key, False), rows, False

        ring, mgr = self.tier.staging_for(s), self.pool.manager(s)
        staged = 0
        try:
            for (gid, key, pre), devs in self._through_ring(uploads(), ring):
                self._merge_block_rows([gid], [devs], s)
                mgr.register(gid, key)
                staged += 1
                self.metrics.prefetch_hits += pre
        except StagingFault:
            self._staging_failed(ring)
        self.metrics.host_staged_blocks += staged
        return staged

    def _take_prefetched(self, uid: int, s: int) -> Optional[dict]:
        """Claim ``uid``'s prefetched device rows for its admission or
        staging on shard ``s``; None when nothing was prefetched or the
        copies are another shard's."""
        shard, rows = self._prefetched.pop(uid, (None, None))
        return rows if shard == s else None

    def _drop_prefetched(self, uid: int):
        self._prefetched.pop(uid, None)

    def _prefetch_queued(self):
        """While a request waits in the queue, push its tier-resident
        prefix blocks through the staging ring ahead of its admission,
        which then merges the device copies (``prefetch_hits``). No pins
        are held: the copies are content-addressed and immutable, the ring
        holds its sources until they land, and the arena waits for that
        before it rewrites a recycled buffer. Entries of requests that left
        the queue are dropped here."""
        if (not self.host_prefetch or self.tier is None
                or not self.kv_prefix or self.prefetch_budget == 0):
            return
        queued = {r.uid for r in self.queue.requests()}
        for uid in list(self._prefetched):
            if uid not in queued:
                self._drop_prefetched(uid)
        budget = self.prefetch_budget

        def uploads(prompt, s):
            # the leading resident run, within the step's budget
            nonlocal budget
            nb_full = (len(prompt) - 1) // self.block_size
            for key in chain_hashes(prompt, self.block_size, nb_full):
                if budget <= 0 or not self.tier.has_kv(s, key):
                    return
                rows = self.tier.get_kv(s, key)
                if rows is None:
                    return
                yield key, rows, False
                budget -= 1

        for req in self.queue.lookahead(max(self.lookahead, 1)):
            if budget <= 0:
                break
            if req.uid in self._prefetched or req.uid in self.parked:
                continue
            # the shard an admission would pick now: the most headroom (a
            # request admitted elsewhere just wastes the copies)
            s = max(range(self.topo.data_size), key=self._headroom)
            ring = self.tier.staging_for(s)
            rows_by_key = {}
            try:
                for key, devs in self._through_ring(
                        uploads(np.asarray(req.prompt, np.int64), s), ring):
                    rows_by_key[key] = devs
            except StagingFault:
                self._staging_failed(ring)
            if rows_by_key:
                self._prefetched[req.uid] = (s, rows_by_key)

    # -- priority preemption ---------------------------------------------
    def _live_blocks(self, b: int) -> int:
        """Leading owned blocks whose contents the next round still reads:
        those holding positions [0, n - 1). The verify window re-encodes
        position n - 1 onward every round, so later blocks need no copy."""
        return -(-max(int(self.n_host[b]) - 1, 0) // self.block_size)

    def preempt_slot(self, b: int) -> Request:
        """Evict running slot ``b``: park its live block contents, recurrent
        rows, tokens and window on the host (through the tier when there is
        one), spill its blocks (hashed prompt blocks stay hittable), free
        the slot and requeue the request at its original rank for an exact
        resume. The parked window and the position-keyed noise make the
        resumed run's tokens, and its verify rounds, those of an
        uninterrupted one."""
        req = self.slots[b]
        assert req is not None, f"slot {b} is not occupied"
        nb_live = self._live_blocks(b)
        self.parked[req.uid] = self._park_tiered(req, b, nb_live)
        self._mgr(b).spill(self.owned[b])
        self.owned[b] = []
        self.slots[b] = None
        self._clear_row(b, release=False)
        self.queue.requeue(req)
        self._journal("park", uid=int(req.uid))
        req.preemptions += 1
        self.metrics.preemptions += 1
        self.metrics.blocks_parked += nb_live
        return req

    def _park_tiered(self, req: Request, b: int,
                     nb_live: int) -> ParkedSequence:
        """Park slot ``b`` on the host. With a tier its full prompt blocks
        go to the shared ``kv`` namespace, pinned, stored once however many
        parked sequences share the prefix (a resident key is pinned, not
        copied again), and the private rest (the recurrent rows, then the
        tail blocks) is one park entry. Without one, or where the arena
        refuses the entry, the private part stays as raw host tensors (a
        park never fails)."""
        sh, r = self._local(b)
        s = sh.index
        prompt = np.asarray(req.prompt)
        nb_pub = (min((len(prompt) - 1) // self.block_size, nb_live)
                  if self._kv_share and self.tier is not None else 0)
        keys = chain_hashes(prompt, self.block_size, nb_pub)
        # pull only the blocks whose keys are not resident already
        need = [jb for jb in range(nb_pub)
                if not self.tier.has_kv(s, keys[jb])]
        payloads = dict(zip(need, self._collect_block_payload(
            [int(self.tables[b, jb]) for jb in need], s)))
        kv_keys = []
        for jb in range(nb_pub):
            ok = (self.tier.put_kv(s, keys[jb], payloads[jb], pin=True)
                  if jb in payloads else self.tier.pin_kv(s, keys[jb]))
            if not ok:           # arena full or entry gone: rest is private
                break
            kv_keys.append(keys[jb])
        tail = self._collect_block_payload(
            [int(self.tables[b, jb]) for jb in range(len(kv_keys), nb_live)],
            s) if self.has_attn else [[] for _ in range(len(kv_keys),
                                                       nb_live)]
        rec = self._collect_rec_row(b) if self.recurrent else []
        private = list(rec)
        for rows in tail:
            private.extend(rows)
        in_arena = (self.tier is not None
                    and self.tier.put_park(req.uid, private))
        row = pull_rows([sh.tokens, sh.cand], [r], self._pin_host)[0][0]
        return ParkedSequence(
            n=int(self.n_host[b]), tokens=row[:self.max_len].numpy(),
            cand=row[self.max_len:].numpy(), nb_live=nb_live,
            kv_keys=tuple(kv_keys), n_rec=len(rec),
            rows_per_block=len(tail[0]) if tail else 0, in_arena=in_arena,
            private=None if in_arena else private, shard=s)

    def _restore_row(self, b: int, req: Request, parked: ParkedSequence):
        """Slot ``b``'s park-time ``tokens``/``n``/``cand`` and stream,
        pushed to its shard's device (a park may resume on another
        shard)."""
        sh, r = self._local(b)
        sh.tokens[r] = torch.from_numpy(parked.tokens).to(sh.device)
        sh.n[r] = parked.n
        sh.cand[r] = torch.from_numpy(parked.cand).to(sh.device)
        self.seq_ids[b] = req.seq_id
        self._stale(b, "seq")
        self.n_host[b] = parked.n

    def _resume(self, req: Request, b: int, parked: ParkedSequence):
        """Re-admit a parked request into slot ``b`` where it left off; a
        cold park (restored from a checkpoint) by prefill, over what the
        device cache, the arena and the disk still hold."""
        req.admit_time = self._now()
        if parked.cold:
            self.metrics.resume_recomputes += 1
            return self._resume_cold(req, b, parked)
        self._resume_tiered(req, b, parked)

    def _resume_tiered(self, req: Request, b: int, parked: ParkedSequence):
        """The exact resume of a park: device hits first (the spill left
        hashed blocks cached-free), then the pinned shared ``kv`` entries
        of a park through the tier, then the private tail (one H2D copy
        per dtype); the recurrent rows come from the private part. The
        full prompt blocks rebuilt are published again. The whole payload
        is fetched before any engine state is touched: a piece gone (a
        checksum failure, a tripped tier) sends the resume to
        ``_resume_cold`` with nothing to unwind."""
        prompt = np.asarray(req.prompt, np.int64)
        L_p = len(prompt)
        # the pinned entries live under the parking shard's key space; the
        # resume may land on another shard, whose pool the rows merge into
        shard = parked.shard
        s, mgr = self._shard_of(b).index, self._mgr(b)
        nb_live = parked.nb_live
        n_shared = len(parked.kv_keys)
        private = (self.tier.take_park(req.uid) if parked.in_arena
                   else (parked.private or []))
        shared, missing = [], parked.in_arena and private is None
        if not missing:
            for key in parked.kv_keys:
                rows = self.tier.get_kv(shard, key)
                if rows is None:      # pinned entry corrupt, tier tripped
                    missing = True
                    break
                shared.append(rows)
        if missing:
            self._discard_park(req.uid, parked)
            self.metrics.resume_recomputes += 1
            return self._resume_cold(req, b, parked)
        # the private part: the recurrent rows, then the tail blocks'
        rec_rows = private[:parked.n_rec]
        tail = private[parked.n_rec:]
        rpb = parked.rows_per_block

        hits, keys = [], []
        nb_full = min((L_p - 1) // self.block_size, nb_live)
        if self._kv_share and nb_full:
            hits, keys = mgr.lookup_prefix(prompt, nb_full)
        self.owned[b] = list(hits)
        self.tables[b] = 0
        self.tables[b, :len(hits)] = hits
        self._stale(b, "tables")
        fresh = mgr.alloc(nb_live - len(hits))
        owned = list(hits) + fresh
        self.owned[b] = list(owned)
        self.tables[b, :nb_live] = owned

        rows = []
        for jb in range(len(hits), nb_live):
            if jb < n_shared:
                rows.append(shared[jb])
            else:
                t0 = (jb - n_shared) * rpb
                rows.append(tail[t0:t0 + rpb])
        self._merge_block_rows(owned[len(hits):], rows, s)
        host_restored = max(0, n_shared - len(hits))
        req.prefix_hit_blocks += len(hits) + host_restored
        if self.recurrent:
            self._restore_rec_row(b, rec_rows)
        self._restore_row(b, req, parked)
        # publish the rebuilt full prompt blocks again, drop the park pins
        if self._kv_share:
            for jb in range(len(hits), nb_full):
                mgr.register(owned[jb], keys[jb])
        for key in parked.kv_keys:
            self.tier.unpin_kv(shard, key)
        self._occupy(b, req, L_p)
        self.metrics.resumes += 1

    def _resume_cold(self, req: Request, b: int, parked: ParkedSequence):
        """Rebuild a parked slot by recompute when a piece of its payload is
        gone: prefill positions ``[0, n - 1)`` from the parked token row,
        then restore the ``tokens``/``n``/``cand`` snapshot. K/V and
        recurrent states at a position are functions of the tokens before
        it; on the CPU the chunks change no number, so the tokens equal a
        warm resume's bitwise, while on the card the chunks' products round
        otherwise than the verify windows that wrote those positions, and
        the tokens agree under the margin rule. It costs prefill. Attention
        stacks hit the device cache and restage from the tier first;
        recurrent stacks rebuild from the zero state, their snapshot having
        gone with the payload."""
        prompt = np.asarray(req.prompt, np.int64)
        L_p = len(prompt)
        n = parked.n
        nb_live = parked.nb_live
        toks = np.asarray(parked.tokens, np.int64)
        (sh, r), mgr = self._local(b), self._mgr(b)
        hits, keys, host_keys = [], [], []
        nb_full = min((L_p - 1) // self.block_size, nb_live)
        if self._kv_share and nb_full and not self.recurrent:
            hits, keys, host_keys = mgr.lookup_prefix_tiered(
                prompt, nb_full, tier=self.tier, shard=sh.index)
        self.owned[b] = list(hits)
        self.tables[b] = 0
        self.tables[b, :len(hits)] = hits
        self._stale(b, "tables")
        staged = (self._stage_host_blocks(
            host_keys, functools.partial(self._grow_run, b, len(hits)),
            sh.index) if host_keys else 0)
        req.prefix_hit_blocks += len(hits) + staged
        self._ensure_capacity(b, nb_live * self.block_size)
        TransformerLM.reset_rows(self.cfg, sh.paged, r)
        start = (len(hits) + staged) * self.block_size
        table_row = torch.from_numpy(self.tables[b:b + 1].copy()).to(
            sh.device)
        for C in prefill_chunks(n - 1 - start, self.prefill_chunk):
            chunk = torch.from_numpy(toks[None, start:start + C]).to(
                sh.device)
            self._prefill(table_row, b, chunk, start)
            start += C
            req.prefill_calls += 1
            self.metrics.prefill_calls += 1
        if self._kv_share and not self.recurrent:
            for j in range(len(hits) + staged, nb_full):
                mgr.register(self.owned[b][j], keys[j])
        self._restore_row(b, req, parked)
        self._occupy(b, req, L_p)
        self.metrics.resumes += 1

    def _discard_park(self, uid: int, parked: ParkedSequence):
        """Drop a parked payload that will not be resumed (a cancel, a
        failed resume): its host buffers, its park entry and its pins on
        the shared blocks, once (a second call finds nothing to release). A
        cold park holds nothing in this process: unpinning its keys could
        take a pin a live park of the same prompt owns."""
        parked.private = None
        if self.tier is None or parked.cold:
            return
        if parked.in_arena:
            self.tier.drop_park(uid)
        for key in parked.kv_keys:
            self.tier.unpin_kv(parked.shard, key)
        parked.in_arena, parked.kv_keys = False, ()

    # -- sequence migration -------------------------------------------------
    def migrate_slot(self, b_src: int, b_dst: int):
        """Move the live sequence in slot ``b_src`` to the free slot
        ``b_dst``. Across shards its owned blocks are copied into fresh
        landing blocks of the destination's sub-pool (``begin_migration``,
        the device copy, ``finish_migration``), and its copied full prompt
        blocks are published in the destination's prefix cache; within
        one shard the blocks stay where they are. Its recurrent rows move
        (the source's zeroed), and so do its ``tokens``/``n``/``cand``
        rows, stream, prompt length, target, reservation and poison flag;
        the source slot is cleared without a release (the blocks moved,
        they were not freed). The tokens do not change: the contents are
        copied bitwise and the noise is keyed by stream and position. The
        caller sees to capacity (``_try_rebalance`` checks the
        reservation); a MemoryError from the landing allocation leaves
        everything as it was."""
        req = self.slots[b_src]
        assert req is not None, f"slot {b_src} is not occupied"
        assert self.slots[b_dst] is None, f"slot {b_dst} is occupied"
        (src, r_src), (dst, r_dst) = self._local(b_src), self._local(b_dst)
        s, t = src.index, dst.index
        n_owned = len(self.owned[b_src])
        ids = (None, None)
        if s == t:
            new_owned = list(self.owned[b_src])
        else:
            new_owned = self.pool.begin_migration(s, t, n_owned)
            ids = self._migration_ids(self.tables[b_src, :n_owned],
                                      new_owned, src, dst)
            self.metrics.blocks_migrated += n_owned
        rows = (torch.tensor([r_src], device=src.device),
                torch.tensor([r_dst], device=dst.device))
        self._contract_check(
            "migration_copy",
            functools.partial(self._migration_copy, s=s, t=t), ids + rows,
            shards=(s,) if s == t else (s, t))
        if s != t:
            self.pool.finish_migration(s, self.owned[b_src])
            if self._kv_share:
                # the copied full prompt blocks the sequence has written
                # (all of them past its prompt) join the destination's
                # cache; the first writer of a key wins
                prompt = np.asarray(req.prompt)
                nb_full = min((len(prompt) - 1) // self.block_size, n_owned,
                              (int(self.n_host[b_src]) - 1)
                              // self.block_size)
                keys = chain_hashes(prompt, self.block_size, nb_full)
                for j in range(nb_full):
                    self.pool.manager(t).register(new_owned[j], keys[j])
        for name in ("tokens", "n", "cand"):
            getattr(dst, name)[r_dst] = getattr(src, name)[r_src].to(
                dst.device)
        self.tables[b_dst] = 0
        self.tables[b_dst, :n_owned] = new_owned
        self.owned[b_dst] = list(new_owned)
        self.slots[b_dst] = req
        for mirror in (self.target, self.reserved, self.n_host, self.seq_ids,
                       self.plen, self.poison):
            mirror[b_dst] = mirror[b_src]
        self._stale(b_dst)
        self.slots[b_src] = None
        self.owned[b_src] = []
        self._clear_row(b_src, release=False)
        req.migrations += 1
        self.metrics.migrations += 1

    def _migration_ids(self, src_blocks, dst_blocks, src: _Shard,
                       dst: _Shard) -> tuple:
        """A cross-shard copy's block ids on each shard's device, padded to
        the table width by repeating the last pair (a padded lane rewrites
        a real block with the same contents: the pools' sink blocks are
        never touched, and one argument shape serves every migration)."""
        pad = self.nb - len(src_blocks)
        return tuple(
            torch.from_numpy(np.pad(np.asarray(ids, np.int64), (0, pad),
                                    mode="edge")).to(sh.device)
            for ids, sh in ((src_blocks, src), (dst_blocks, dst)))

    def _migration_copy(self, src_ids, dst_ids, src_row, dst_row, *, s: int,
                        t: int):
        """The device half of a migration, in place: shard ``s``'s pool
        rows ``src_ids`` copied into shard ``t``'s ``dst_ids`` (None: one
        shard, the blocks stay), then each recurrent row moved from
        ``src_row`` on ``s`` to ``dst_row`` on ``t`` and the source row
        zeroed. The host sync that ended the last step orders it after
        the source shard's last round."""
        src, dst = self.shards[s].paged, self.shards[t].paged
        dev = self.shards[t].device
        if src_ids is not None:
            for a, b in zip(TransformerLM.pool_leaves(self.cfg, src),
                            TransformerLM.pool_leaves(self.cfg, dst)):
                b[dst_ids] = a[src_ids].to(dev)
        for a, b in zip(TransformerLM.state_leaves(self.cfg, src),
                        TransformerLM.state_leaves(self.cfg, dst)):
            b[dst_row] = a[src_row].to(dev)
            a[src_row] = 0

    def _evictable(self, head: Request) -> list[int]:
        """Running slots the queue head may preempt: of strictly lower
        priority and below the progress floor (a slot past
        ``preempt_floor`` of its generation frees soon anyway). Lowest
        priority first, then the cheapest park."""
        out = []
        for b in range(self.B):
            r = self.slots[b]
            if r is None or r.priority <= head.priority:
                continue
            prog = (int(self.n_host[b]) - len(r.prompt)) / max(
                1, r.new_tokens)
            if prog >= self.preempt_floor:
                continue
            out.append(b)
        out.sort(key=lambda b: (-self.slots[b].priority,
                                self._live_blocks(b)))
        return out

    def _try_preempt(self, head: Request) -> Optional[int]:
        """Priority preemption on a single shard: of each shard's evictable
        slots, the shortest prefix whose freed reservations and the shard's
        headroom cover the head's worst case; the fewest victims win (on a
        tie, the shard of the most evictable slot). Each victim is parked
        for its exact resume, and the head routed."""
        if not self.preempt:
            return None
        need = self._worst_case_blocks(head)
        by_shard: dict[int, list[int]] = {}
        for b in self._evictable(head):
            by_shard.setdefault(self._shard_of(b).index, []).append(b)
        best = None
        for s, victims in by_shard.items():
            gain, took = self._headroom(s), []
            for b in victims:
                gain += int(self.reserved[b])
                took.append(b)
                if gain >= need:
                    break
            if gain >= need and (best is None or len(took) < len(best)):
                best = took
        if best is None:
            return None
        for b in best:
            self.preempt_slot(b)
        return self._route(head)

    def _poll_queue_deadlines(self):
        """Count the SLO expiries of requests still queued or parked (once
        per request): without this, a request that blows its deadline
        before it runs is not seen until it finishes."""
        now = self._now()
        for req in self.queue.requests():
            if (req.deadline is not None and not req.queue_deadline_missed
                    and now > req.deadline_time):
                req.queue_deadline_missed = True
                self.metrics.deadline_missed_in_queue += 1

    # -- staging area ---------------------------------------------------------
    def _unstage_all(self):
        """Every staged request back to the queue at its original rank, and
        its blocks back to the pool (hashed hits drop to cached-free)."""
        for sh in self.shards:
            for e in sh.staged:
                self.pool.manager(sh.index).release_all(e.blocks)
                self.ledger.release(sh.index, e.req.uid)
                self.queue.requeue(e.req)
            sh.staged = []

    def _reconcile_staging(self):
        """The staging invariants at every sync: staged entries exist only
        while every slot is busy (a free slot hands the backlog back to
        host admission, with its lookahead and preemption), and the area
        never outranks the queue head (a higher-priority arrival unstages
        it)."""
        staged = self.staged
        if not staged:
            return
        if any(s is None for s in self.slots):
            self._unstage_all()
            return
        head = self.queue.peek()
        if head is not None:
            hk = (head.priority, head.deadline_time, head._seq)
            if any(hk < e.key for e in staged):
                self._unstage_all()

    def _build_staged(self, req: Request, s: int, need: int) -> StagedEntry:
        """Stage ``req`` on shard ``s``: its worst-case blocks allocated
        now (an adopted row never allocates in the loop), device prefix
        hits and blocks restaged from the host tier covering its leading
        prompt positions. Recurrent stacks stage from scratch: their state
        row is zeroed at adoption, and a KV prefix without its snapshot
        would not match it. Fresh blocks are not published: their contents
        become valid only as the forced prefill writes them."""
        mgr = self.pool.manager(s)
        prompt = np.asarray(req.prompt, np.int64)
        L_p = len(prompt)
        hits, host_keys = [], []
        nb_full = (L_p - 1) // self.block_size
        if self._kv_share and nb_full and not self.recurrent:
            hits, _, host_keys = mgr.lookup_prefix_tiered(
                prompt, nb_full, tier=self.tier, shard=s)
        try:
            fresh = mgr.alloc(need - len(hits))
        except Exception:
            mgr.release_all(hits)
            raise
        blocks = list(hits) + fresh
        try:
            staged_host = (self._stage_host_blocks(
                host_keys, lambda n: blocks[len(hits):len(hits) + n], s,
                prefetched=self._take_prefetched(req.uid, s))
                if host_keys else 0)
        except Exception:
            mgr.release_all(blocks)
            raise
        cov = len(hits) + staged_host
        req.prefix_hit_blocks = cov
        table_row = np.zeros(self.nb, np.int32)
        table_row[:len(blocks)] = blocks
        return StagedEntry(
            req=req, shard=s, prompt=prompt.astype(np.int32),
            n0=cov * self.block_size + 1, plen=L_p,
            target=L_p + req.new_tokens, blocks=blocks,
            table_row=table_row, poison=int(self._poisoned(req)),
            key=(req.priority, req.deadline_time, req._seq))

    def _stage_pending(self):
        """Fill the staging areas from the queue in queue order, only while
        every slot is busy, each request on the shard with room in its area
        and the most headroom (the lowest shard on a tie). Stops at the
        first request that cannot stage (skipping it would let a later one
        adopt first); a parked request needs the host's resume. Claims go
        through the ledger, out of the headroom net of resident
        reservations."""
        if self.staging_slots == 0 or not self.queue:
            return
        if any(s is None for s in self.slots):
            return
        capacity = sum(self.staging_slots - len(sh.staged)
                       for sh in self.shards)
        if capacity <= 0:
            return
        for req in self.queue.lookahead(capacity):
            if req.uid in self.parked:
                break
            need = self._worst_case_blocks(req)
            best = None
            for sh in self.shards:
                if len(sh.staged) >= self.staging_slots:
                    continue
                h = self._headroom(sh.index)
                if h >= need and (best is None or h > best[1]):
                    best = (sh.index, h)
            if best is None or not self.ledger.try_claim(best[0], req.uid,
                                                         need, best[1]):
                break
            s = best[0]
            try:
                entry = self._build_staged(req, s, need)
            except Exception:
                # staging only saves syncs: the request stays queued
                self.ledger.release(s, req.uid)
                break
            self.queue.remove(req)
            self._drop_prefetched(req.uid)
            self.shards[s].staged.append(entry)
            self.metrics.staged_sequences += 1

    def _harvest_adoptions(self, s: int, adopt: np.ndarray,
                           out_tok: np.ndarray,
                           now: float) -> tuple[int, int, int]:
        """Replay shard ``s``'s in-loop adoptions on the host. Descriptors
        were adopted in FIFO order, so walking them in order meets, at
        descriptor ``i``, the slot's host occupant as exactly the episode
        the loop displaced: a finished one delivers the tokens kept at
        displacement, a bad one goes through ``_fail_request``; its blocks
        are released without ``_clear_row``, since the device row already
        switched. The adopted entry's host mirrors are set without dropping
        the device copies. Returns ``(accepted, active_row_rounds,
        generating_row_rounds)`` of the displaced episodes."""
        sh, mgr = self.shards[s], self.pool.manager(s)
        acc_extra = act_extra = gen_extra = 0
        n_adopted = 0
        for i, entry in enumerate(sh.staged):
            row = adopt[i]
            if row[0] < 0:
                break               # adopted descriptors are a prefix
            n_adopted += 1
            g = self.topo.global_slot(s, int(row[0]), self.B)
            ep_n, ep_acc, ep_act = int(row[1]), int(row[2]), int(row[3])
            ep_bad, ep_gen = int(row[4]), int(row[5])
            prev = self.slots[g]
            if prev is not None:
                prev.calls_used += ep_act
                acc_extra += ep_acc
                act_extra += ep_act
                gen_extra += ep_gen
                mgr.release_all(self.owned[g])
                self.owned[g] = []
                self.slots[g] = None
                if ep_bad:
                    self._fail_request(
                        prev, "nonfinite" if ep_bad & 1 else "stuck",
                        f"health bits 0b{ep_bad:02b} at n={ep_n} "
                        "(displaced in the loop)", retryable=True,
                        fresh_stream=True)
                else:
                    prev.result = out_tok[i, :ep_n].copy()
                    prev.finish_time = now
                    self.metrics.observe_finish(prev)
                    self.done.append(prev)
                    self._journal_finish(prev)
            req = entry.req
            req.admit_time = now
            self.ledger.release(s, req.uid)
            self.slots[g] = req
            self.owned[g] = list(entry.blocks)
            self.tables[g] = entry.table_row
            self.target[g] = entry.target
            self.plen[g] = entry.plen
            self.seq_ids[g] = req.seq_id
            self.poison[g] = entry.poison
            self.reserved[g] = len(entry.blocks)
            self.metrics.in_loop_adoptions += 1
        sh.staged = sh.staged[n_adopted:]
        return acc_extra, act_extra, gen_extra

    # -- admission ----------------------------------------------------------
    def _worst_case_blocks(self, req: Request) -> int:
        # every prompt+generation block a fresh allocation, window at W_max
        return -(-(len(req.prompt) + req.new_tokens + self.W_max)
                 // self.block_size)

    def _headroom(self, s: int) -> int:
        """Shard ``s``'s free blocks net of those promised to its in-flight
        slots but not yet allocated (their tables grow lazily as n
        advances)."""
        owed = sum(max(0, int(self.reserved[b]) - len(self.owned[b]))
                   for b in self.topo.slot_range(s, self.B)
                   if self.slots[b] is not None)
        return self.pool.available(s) - owed

    def _free_slot_in(self, s: int) -> Optional[int]:
        return next((b for b in self.topo.slot_range(s, self.B)
                     if self.slots[b] is None), None)

    def _route(self, req: Request) -> Optional[int]:
        """Pool-pressure routing: the lowest free slot of the shard with
        the most headroom that covers the request's worst case (on one
        shard: the lowest free slot, iff the pool covers it)."""
        headroom = {s: self._headroom(s) for s in range(self.topo.data_size)
                    if self._free_slot_in(s) is not None}
        s = self.pool.route(self._worst_case_blocks(req), headroom)
        return None if s is None else self._free_slot_in(s)

    def _try_rebalance(self, req: Request) -> Optional[int]:
        """Shard rebalancing, when no shard has both a free slot and the
        headroom for ``req``: migrate a resident to another shard where its
        whole reservation fits, if its leaving frees enough on its home
        shard (its slot, and its blocks and reservation) to admit ``req``
        there. The move copying the fewest blocks wins (then the lowest
        slots). Returns the admission slot, or None."""
        if not self.rebalance or self.topo.data_size == 1:
            return None
        need = self._worst_case_blocks(req)
        best = None
        for v in range(self.B):
            if self.slots[v] is None:
                continue
            home = self._shard_of(v).index
            if self._headroom(home) + int(self.reserved[v]) < need:
                continue
            for t in range(self.topo.data_size):
                b_dst = self._free_slot_in(t)
                if (t == home or b_dst is None
                        or self._headroom(t) < int(self.reserved[v])):
                    continue
                cand = (len(self.owned[v]), v, b_dst)
                if best is None or cand < best:
                    best = cand
        if best is None:
            return None
        _, v, b_dst = best
        try:
            self.migrate_slot(v, b_dst)
        except MemoryError:
            # a landing allocation fault: nothing moved yet
            return None
        return self._route(req)

    def _admit_pending(self):
        """Lookahead admission: scan up to ``lookahead`` queued requests in
        queue order and admit the first routable one. Any of them may claim
        room by rebalancing the shards; the head alone also by preempting
        lower-priority slots (for a later request that would invert the
        queue's order). Every admission that
        jumps the head ages it, and at ``max_head_bypass`` the scan narrows
        to the head alone so it cannot starve."""
        while self.queue:
            cands = self.queue.lookahead(self.lookahead)
            head = cands[0]
            if head.bypassed >= self.max_head_bypass:
                cands = [head]
            admitted = None
            faulted = False
            for req in cands:
                b = self._route(req)
                if b is None:
                    b = self._try_rebalance(req)
                if b is None and req is head:
                    b = self._try_preempt(head)
                if b is not None:
                    self.queue.remove(req)
                    try:
                        self._admit(req, b)
                    except MemoryError as e:
                        # a block allocation failed: the failure is this
                        # request's alone, so unwind its half-built slot
                        # (releasing the blocks it took), retry or fail
                        # it, and scan again
                        self.slots[b] = None
                        self._clear_row(b)
                        self._fail_request(
                            req, "admission", f"{type(e).__name__}: {e}",
                            retryable=True)
                        faulted = True
                    admitted = req
                    break
            if admitted is None:
                break
            if faulted:
                continue
            if admitted is not head:
                head.bypassed += 1
                self.metrics.head_bypass_admissions += 1

    def _admit(self, req: Request, b: int):
        parked = self.parked.pop(req.uid, None)
        if parked is not None:            # preempted: the exact resume
            try:
                self._resume(req, b, parked)
            except Exception:
                # a retry re-admits from the prompt, on the same stream
                self._discard_park(req.uid, parked)
                raise
            self._journal("admit", uid=int(req.uid))
            kill_point("post_admit")
            return
        req.admit_time = self._now()
        prompt = np.asarray(req.prompt, np.int64)
        L_p = len(prompt)
        (sh, r), mgr = self._local(b), self._mgr(b)
        s = sh.index
        # prefix cache: reuse full blocks strictly below position L_p - 1
        # (the verify window rewrites position n-1 = L_p-1 onward, so those
        # blocks stay read-only and shareable); the cache is the shard's
        # own, and its device misses fall through to the host tier
        hits, keys, host_keys = [], [], []
        nb_full = (L_p - 1) // self.block_size
        if self._kv_share and nb_full:
            hits, keys, host_keys = mgr.lookup_prefix_tiered(
                prompt, nb_full, tier=self.tier, shard=s)
        elif self.rec_prefix and nb_full:
            keys = chain_hashes(prompt, self.block_size, nb_full)

        rec_rows, rec_bound = None, 0
        if self.rec_prefix and nb_full:
            # a recurrent prefix hit needs both halves at one block boundary
            # j: KV blocks [0, j) covered (device hits and the host run; all
            # of them without attention layers) and the state snapshot at
            # keys[j - 1]; take the largest such j
            cover = (len(hits) + len(host_keys)) if self.has_attn else nb_full
            rec_rows, rec_bound = self._snapshot_at_or_below(keys, cover, s)
            # prefill rewrites blocks >= j through the table, so device hits
            # past the boundary (shared blocks) are released
            if len(hits) > rec_bound:
                mgr.release_all(hits[rec_bound:])
                hits = hits[:rec_bound]
            host_keys = keys[len(hits):rec_bound] if self.has_attn else []

        self.owned[b] = list(hits)
        self.tables[b] = 0
        self.tables[b, :len(hits)] = hits
        self._stale(b, "tables")
        pre = self._take_prefetched(req.uid, s)
        staged = (self._stage_host_blocks(
            host_keys, functools.partial(self._grow_run, b, len(hits)), s,
            prefetched=pre) if host_keys else 0)
        if (self.rec_prefix and self.has_attn
                and rec_bound > len(hits) + staged):
            # staging was cut short: the best boundary it still covers.
            # Prefill rewrites the blocks past it, so they go back (shared
            # hits and registered restaged blocks stay hittable, unchanged)
            rec_rows, rec_bound = self._snapshot_at_or_below(
                keys, len(hits) + staged, s)
            mgr.release_all(self.owned[b][rec_bound:])
            self.owned[b] = self.owned[b][:rec_bound]
            self.tables[b, rec_bound:] = 0
            self._stale(b, "tables")
            staged = max(0, rec_bound - len(hits))
            hits = hits[:rec_bound]
        self._ensure_capacity(b, L_p)
        start_blocks = rec_bound if self.rec_prefix else len(hits) + staged
        req.prefix_hit_blocks = start_blocks

        dev = sh.device
        row_tokens = torch.zeros((self.max_len,), dtype=torch.int64)
        row_tokens[:L_p] = torch.from_numpy(prompt)
        sh.tokens[r] = row_tokens.to(dev)
        sh.n[r] = L_p
        sh.cand[r] = 0
        sh.cand[r, 0] = int(prompt[-1])
        self.seq_ids[b] = req.seq_id
        self._stale(b, "seq")
        TransformerLM.reset_rows(self.cfg, sh.paged, r)
        if rec_rows is not None and start_blocks > 0:
            # the state after positions [0, start_blocks * bs), captured at
            # this boundary by an earlier admission
            self._restore_rec_row(b, rec_rows)
            self.metrics.rec_snapshot_restores += 1

        # chunked row-local prefill of the un-cached prompt tail; recurrent
        # stacks cut it at every block boundary to snapshot the state there
        # (on the CPU the chunks change no number, so neither the tokens)
        start = start_blocks * self.block_size
        table_row = torch.from_numpy(self.tables[b:b + 1].copy()).to(dev)
        seg_ends = ([jb * self.block_size
                     for jb in range(start_blocks + 1, nb_full + 1)]
                    if self.rec_prefix else [])
        if not seg_ends or seg_ends[-1] != L_p - 1:
            seg_ends.append(L_p - 1)
        for end in seg_ends:
            for C in prefill_chunks(end - start, self.prefill_chunk):
                chunk = torch.from_numpy(prompt[None, start:start + C]).to(dev)
                self._prefill(table_row, b, chunk, start)
                start += C
                req.prefill_calls += 1
                self.metrics.prefill_calls += 1
            if (self.rec_prefix and end > 0 and end == start
                    and end % self.block_size == 0
                    and end <= nb_full * self.block_size):
                key = keys[end // self.block_size - 1]
                if not self.tier.has_rec(s, key) and self.tier.put_rec(
                        s, key, self._collect_rec_row(b)):
                    self.metrics.rec_snapshot_captures += 1
        # publish this prompt's freshly computed full blocks (restaged ones
        # were registered as they merged)
        if self._kv_share:
            for j in range(len(hits) + staged, nb_full):
                mgr.register(self.owned[b][j], keys[j])
        self._occupy(b, req, L_p)
        self.n_host[b] = L_p
        self._journal("admit", uid=int(req.uid))
        kill_point("post_admit")

    def _snapshot_at_or_below(self, keys, cover: int, s: int):
        """The recurrent snapshot at the largest block boundary ``j <=
        cover`` shard ``s``'s key space of the tier holds, copied out of
        the arena (the allocations that follow may spill into it and
        recycle its buffers), and ``j``; ``(None, 0)`` when there is
        none."""
        for j in range(cover, 0, -1):
            rows = self.tier.get_rec(s, keys[j - 1])
            if rows is not None:
                return self.tier.arena.copy_out(rows), j
        return None, 0

    # -- failure and cancellation --------------------------------------------
    def _fail_request(self, req: Request, code: str, detail: str = "", *,
                      retryable: bool = False, fresh_stream: bool = False):
        """Retire or retry a request that hit a fault. A retryable failure
        under the retry budget requeues it at its original rank;
        ``fresh_stream`` also gives it a new noise-stream id (the
        reference's walk, skipping the plan's poisoned streams), so a
        quarantined request does not replay the stream that failed.
        Otherwise it finishes with a ``RequestError`` and no result."""
        if retryable and req.retries < self.request_retries:
            req.retries += 1
            self.metrics.retries += 1
            if fresh_stream:
                req.noise_seed = fresh_stream_id(
                    req.seq_id, self.faults.poison_streams
                    if self.faults is not None else frozenset())
            self.queue.requeue(req)
            # the new stream must survive a crash: the noise is keyed by it
            self._journal("retry", uid=int(req.uid),
                          noise_seed=req.noise_seed, retries=req.retries)
            return
        req.error = RequestError(code, detail, retryable=retryable,
                                 attempts=req.retries + 1)
        req.result = None
        req.finish_time = self._now()
        self.metrics.requests_failed += 1
        self.done.append(req)
        self._journal("fail", uid=int(req.uid), code=code)

    def _fail_slot(self, b: int, code: str, detail: str = "", *,
                   retryable: bool = False, fresh_stream: bool = False):
        """Quarantine running slot ``b``: free it (blocks released, its row
        back to the inactive lane), as a finished request's slot is freed,
        and route its request through ``_fail_request``."""
        req = self.slots[b]
        self.slots[b] = None
        self._clear_row(b)
        self._fail_request(req, code, detail, retryable=retryable,
                           fresh_stream=fresh_stream)

    def cancel(self, uid: int) -> bool:
        """Cancel a request wherever it is: queued (a parked one waits in
        the queue, and its payload is dropped), staged (its blocks and
        claim released; the device holds only a descriptor copy, packed
        again for every loop) or running (its slot freed at once, which
        leaves the other rows exactly as they were). It finishes through
        ``done`` with ``error.code == "cancelled"``. Returns False for an
        unknown ``uid`` (finished, or never submitted)."""
        self._tick()
        for req in self.queue.requests():
            if req.uid == uid:
                self.queue.remove(req)
                self._drop_prefetched(uid)
                parked = self.parked.pop(uid, None)
                if parked is not None:
                    self._discard_park(uid, parked)
                self._finalize_cancel(req)
                return True
        for sh in self.shards:
            for i, e in enumerate(sh.staged):
                if e.req.uid == uid:
                    self.pool.manager(sh.index).release_all(e.blocks)
                    self.ledger.release(sh.index, uid)
                    del sh.staged[i]
                    self._drop_prefetched(uid)
                    self._finalize_cancel(e.req)
                    return True
        for b in range(self.B):
            req = self.slots[b]
            if req is not None and req.uid == uid:
                self.slots[b] = None
                self._clear_row(b)
                self._finalize_cancel(req)
                return True
        return False

    def _finalize_cancel(self, req: Request):
        req.error = RequestError("cancelled", retryable=False,
                                 attempts=req.retries + 1)
        req.result = None
        req.finish_time = self._now()
        self.metrics.requests_cancelled += 1
        self.done.append(req)
        self._journal("cancel", uid=int(req.uid), code="cancelled")

    # -- main loop -----------------------------------------------------------
    def _pending(self) -> bool:
        return bool(self.queue or self.staged
                    or any(s is not None for s in self.slots))

    @torch.no_grad()
    def step(self) -> bool:
        """Count queued deadline expiries, reconcile the staging area, admit
        what fits (preempting for a higher-priority head), stage what
        waits, prefetch the tier-resident prefixes of what is still queued,
        run one loop of up to ``rounds_per_sync`` verify rounds on every
        shard that holds a request (one window W for all), harvest
        adoptions and finished requests. Without staging the loop runs one
        round while requests are queued, so freed slots refill promptly;
        with staging, backlog is when a long loop pays (freed rows adopt
        without a sync), so k comes from the adaptive controller, or is
        ``rounds_per_sync`` while the backlog is staged. Every shard's loop
        is dispatched before the host reads any shard's stats, so shards on
        several devices overlap; the host pulls one small array per shard.
        Returns True while there is work. On a model axis the clock is
        broadcast at the step's top and again after its host sync
        (``_tick``), as model 1 reads it at both."""
        self._tick()
        self._poll_queue_deadlines()
        self._reconcile_staging()
        self._admit_pending()
        self._stage_pending()
        self._prefetch_queued()
        if not any(s is not None for s in self.slots):
            # a free slot unstages, so an empty engine has no staged entry
            if self.queue:
                raise MemoryError(
                    "admission deadlock: queued request cannot fit an empty "
                    "engine (prompt+target exceeds the block pool)")
            return False
        W = self.controller.window
        staged_now = len(self.staged)
        backlog_now = len(self.queue) + staged_now
        if self.staging_slots:
            if self.adaptive_rounds:
                k = min(self.rounds_ctrl.k, self.rounds_per_sync)
            else:
                k = (self.rounds_per_sync if staged_now or not self.queue
                     else 1)
        else:
            k = 1 if self.queue else self.rounds_per_sync
        for b in range(self.B):
            if self.slots[b] is not None:
                try:
                    self._ensure_capacity(b, int(self.target[b]) + W)
                except MemoryError as e:
                    # the reservation keeps this from happening on its own;
                    # an injected allocation fault fails only this slot
                    self._fail_slot(b, "capacity", str(e), retryable=True)
        if not any(s is not None for s in self.slots):
            return bool(self.queue) or bool(self.staged)
        # every busy shard's loop dispatched, then THE host sync: one small
        # packed pull per shard. A shard holding no request is not run: its
        # stats would be its cleared rows' (n = 1, all else 0)
        busy = [sh for sh in self.shards
                if any(self.slots[b] is not None for b in sh.rows)]
        outs = []
        for sh in busy:
            kind, fn, args = self._round_program(W, k, sh.index)
            outs.append(self._contract_check(kind, fn, args,
                                             shards=(sh.index,), variant=k))
        Bl, S = self.B_local, self.staging_slots
        stats = np.zeros((self.B, 7 if S else 5), np.int64)
        stats[:, 2] = self.n_host
        adopt = {}
        if self.model_axis is not None:
            self._agree(busy, outs)
        for sh, out in zip(busy, outs):
            flat = out.cpu().numpy()
            rows = slice(sh.rows.start, sh.rows.stop)
            if S == 0:
                stats[rows] = flat
                continue
            stats[rows] = flat[:Bl * 7].reshape(Bl, 7)
            adopt[sh.index] = (
                flat[Bl * 7:Bl * 7 + S * 6].reshape(S, 6),
                flat[Bl * 7 + S * 6:].reshape(S, self.max_len))
        if S:
            self.metrics.staging_occupancy_hist.append(
                staged_now / (self.topo.data_size * S))
        accepted, rounds_active, n_host = stats[:, 0], stats[:, 1], stats[:, 2]
        bad = stats[:, 4]
        rounds_exec = int(stats[:, 3].max())   # the longest shard's loop
        self.n_host[:] = n_host
        self._last_rounds_exec = rounds_exec

        self._tick()
        now = self._now()
        acc_extra = act_extra = gen_extra = 0
        for s, (ad, out_tok) in adopt.items():
            if bool((ad[:, 0] >= 0).any()):
                extra = self._harvest_adoptions(s, ad, out_tok, now)
                acc_extra += extra[0]
                act_extra += extra[1]
                gen_extra += extra[2]
        slot_rows = [b for b in range(self.B) if self.slots[b] is not None]
        # a row's accumulators restart at adoption, so its stats are its
        # current occupant's; displaced episodes were credited above
        for b in slot_rows:
            self.slots[b].calls_used += int(rounds_active[b])
        act_row_rounds = act_extra + int(rounds_active[slot_rows].sum())
        acc_total = acc_extra + int(accepted[slot_rows].sum())
        self.metrics.observe_loop(W, rounds_exec, act_row_rounds, self.B,
                                  acc_total, backlog=backlog_now)
        if self.staging_slots:
            # W retunes from generating row-rounds: forced prefill accepts
            # at the prompt's rate, not the stream's
            gen_total = gen_extra + int(stats[slot_rows, 5].sum())
            idle_total = int(stats[:, 6].sum())
            self.metrics.idle_row_rounds += idle_total
            self.controller.observe_aggregate(acc_total, gen_total)
            self.rounds_ctrl.observe(rounds_exec, idle_total, self.B,
                                     len(self.queue) + len(self.staged))
        else:
            self.controller.observe_aggregate(acc_total, act_row_rounds)

        for b in slot_rows:
            req = self.slots[b]
            if bad[b]:
                # quarantine: a retry gets a fresh noise stream (the
                # poisoned one would fail again)
                code = "nonfinite" if bad[b] & 1 else "stuck"
                self._fail_slot(b, code, f"health bits 0b{int(bad[b]):02b} "
                                f"at n={int(n_host[b])}", retryable=True,
                                fresh_stream=True)
                continue
            if n_host[b] >= self.target[b]:
                sh, r = self._local(b)
                req.result = sh.tokens[r, :n_host[b]].cpu().numpy().copy()
                req.finish_time = now
                self.metrics.observe_finish(req)
                self.done.append(req)
                self._journal_finish(req)
                self.slots[b] = None
                self._clear_row(b)
                continue
            if (self.max_request_rounds is not None
                    and req.calls_used >= self.max_request_rounds):
                # not retryable: the same stream would run away again
                self._fail_slot(
                    b, "round_budget", f"{req.calls_used} verify rounds "
                    f">= {self.max_request_rounds}")
                continue
            if (self.max_request_seconds is not None
                    and now - req.submit_time > self.max_request_seconds):
                self._fail_slot(
                    b, "timeout", f"{now - req.submit_time:.3f}s "
                    f"> {self.max_request_seconds}s wall time")
        # the durability boundary: the journal on media and the scheduler
        # snapshotted, so a crash from here on recovers this sync's state
        if self.durable_dir is not None:
            if self.journal is not None:
                self.journal.sync()
            self._checkpoint(now)
            kill_point("post_sync")
        return True

    def run(self, max_rounds: int = 10_000) -> list[Request]:
        """Drain the queue; returns completed Requests. ``max_rounds``
        bounds executed verify rounds."""
        budget = int(max_rounds)
        while self._pending():
            if not self.step():
                break
            budget -= self._last_rounds_exec
            if budget <= 0 and self._pending():
                raise RuntimeError(
                    f"serving engine did not converge within {max_rounds} "
                    "verify rounds")
        return self.done

    def close(self) -> None:
        """The durability layer's orderly shutdown: a last checkpoint, the
        journal fsynced and closed. A no-op for a volatile engine, and
        never required: an engine that just dies recovers the same. On a
        model axis every rank calls it (the checkpoint is agreed)."""
        if self.durable_dir is not None:
            self._tick()
            self._checkpoint()
            if self.journal is not None:
                self.journal.close()

    # -- checkpoint and restore -----------------------------------------------
    def _checkpoint(self, now: Optional[float] = None) -> None:
        """Snapshot the scheduler at a host sync, atomically (a temporary
        file, fsync, rename: a reader sees the whole snapshot or the one
        before). It holds every live request's clocks as elapsed durations
        (``clock_export``: monotonic stamps die with the process), arrival
        rank, retries, stream and aging; and for each park its ``n``, token
        row and window and the chain keys of its shared prompt blocks,
        which are first made durable on the disk tier. Parks' private
        payloads and running rows are not in it: a restore recomputes them
        from the journaled identity, so the snapshot stays small.

        On a model axis every rank flushes its own parks' blocks to its own
        disk tier, then the ranks agree on the snapshot (a barrier too: no
        rank's blocks are missing from a snapshot that names them), and
        rank 0 writes it."""
        if self.durable_dir is None:
            return
        if now is None:
            now = self._now()
        live = (list(self.queue.requests()) + [e.req for e in self.staged]
                + [r for r in self.slots if r is not None])
        reqs = [{"uid": int(r.uid),
                 "rank": None if r._seq is None else int(r._seq),
                 "retries": int(r.retries), "noise_seed": r.noise_seed,
                 "bypassed": int(r.bypassed),
                 "queue_deadline_missed": bool(r.queue_deadline_missed),
                 "clocks": r.clock_export(now)} for r in live]
        parked = {}
        for uid, p in self.parked.items():
            if self.tier is not None and p.kv_keys:
                self.tier.flush_to_disk(p.shard, p.kv_keys)
            parked[str(int(uid))] = {
                "n": int(p.n),
                "tokens": [int(t) for t in np.asarray(p.tokens).ravel()],
                "cand": [int(t) for t in np.asarray(p.cand).ravel()],
                "nb_live": int(p.nb_live),
                "kv_keys": [int(k) for k in p.kv_keys],
                "shard": int(p.shard)}
        snap = {"version": 1, "requests": reqs, "parked": parked}
        if self.model_axis is not None:
            self.model_axis.agree(json.dumps(snap, sort_keys=True).encode(),
                                  f"checkpoint {self.metrics.host_syncs}")
        if self._ckpt_path is None:          # a model rank but 0
            return
        tmp = self._ckpt_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(snap, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self._ckpt_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return       # recovery falls back to the journal alone
        self.metrics.checkpoints_written += 1

    def _load_checkpoint(self) -> dict:
        """The latest snapshot, or {} when it is missing or unreadable (the
        restore then runs from the journal alone: every request prefills
        from its prompt, its clocks start again)."""
        if self._ckpt_path is None:
            return {}
        try:
            with open(self._ckpt_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _request_of(self, uid, rec: dict) -> Request:
        """A ``Request`` from its journaled submit record."""
        return Request(uid=int(uid),
                       prompt=np.asarray(rec["prompt"], np.int64),
                       new_tokens=int(rec["new_tokens"]),
                       priority=int(rec.get("priority", 0)),
                       deadline=rec.get("deadline"),
                       noise_seed=rec.get("noise_seed"))

    def restore(self) -> int:
        """Recover the accepted requests a crash left unfinished.

        Replays the journal (repairing a torn tail), folds in the latest
        checkpoint and re-enqueues every pending request at its original
        arrival rank with its clocks rebased; later submits rank behind
        them. A request the checkpoint holds a park of comes back as a cold
        ``ParkedSequence``: its resume restages its prompt blocks through
        the arena and disk fall-through and prefills the rest of ``[0, n -
        1)``; every other one re-admits from its journaled prompt. Either
        way its tokens are an uninterrupted run's, since the context and
        the noise stream were durable.

        Journaled outcomes are delivered again through ``done``: a crash
        can fall between a finish reaching the journal and the client
        reading it, so every journaled finish (its tokens are in the
        record) and failure or cancel (its code) comes back, at least once
        and bitwise the same. Returns the number of requests re-enqueued
        (re-deliveries not counted).

        On a model axis every rank calls it: rank 0 replays the journal and
        reads the checkpoint, and broadcasts both; every rank rebuilds the
        same state from them, the ranks' disk tiers keep only the entries
        all of them hold (a rank killed later than another may have
        spilled more), and the ranks agree on a digest of the rebuilt
        queue, parks and slots."""
        if self.durable_dir is None:
            raise RuntimeError("restore() needs a durable_dir")
        records = ckpt = None
        if self.journal is not None:
            records = RequestJournal.replay(self.journal.path,
                                            faults=self.faults)
            ckpt = self._load_checkpoint()
        if self.model_axis is not None:
            records, ckpt = json.loads(self.model_axis.broadcast_bytes(
                None if records is None else
                json.dumps([records, ckpt]).encode(), src=0))
            self._reconcile_disk()
        pending, _, delivered = RequestJournal.pending(records)
        by_uid = {int(r["uid"]): r for r in ckpt.get("requests", [])}
        snaps = {int(u): p for u, p in ckpt.get("parked", {}).items()}
        self._tick()
        now = self._now()
        max_rank = -1
        recovered = 0
        # the original queue order: ranked submits first, by rank
        for uid, rec in sorted(
                pending.items(),
                key=lambda kv: (kv[1].get("rank") is None,
                                kv[1].get("rank") or 0)):
            req = self._request_of(uid, rec)
            req.retries = int(rec.get("retries", 0))
            req._seq = None if rec.get("rank") is None else int(rec["rank"])
            c = by_uid.get(req.uid)
            if c is not None:
                req.bypassed = int(c.get("bypassed", 0))
                req.queue_deadline_missed = bool(
                    c.get("queue_deadline_missed", False))
                req.clock_rebase(c.get("clocks", {}), now)
            else:
                req.submit_time = now     # journal only: the clock restarts
            if req._seq is None:
                req._seq = max_rank + 1
            max_rank = max(max_rank, req._seq)
            snap = snaps.get(req.uid)
            if snap is not None and rec.get("parked"):
                self.parked[req.uid] = ParkedSequence(
                    n=int(snap["n"]),
                    tokens=np.asarray(snap["tokens"], np.int64),
                    cand=np.asarray(snap["cand"], np.int64),
                    nb_live=int(snap["nb_live"]),
                    kv_keys=tuple(int(k) for k in snap["kv_keys"]),
                    shard=int(snap["shard"]), cold=True)
                self.metrics.recovered_parked += 1
            self.queue.requeue(req)       # its rank is pinned already
            recovered += 1
        self.queue.advance_seq(max_rank)
        self.metrics.recovered_requests += recovered
        # journaled outcomes the crash may have kept from their client; no
        # journal write: the records are terminal already
        for uid, rec in delivered.items():
            req = self._request_of(uid, rec)
            if rec["terminal"] == "finish" and "tokens" in rec:
                req.result = np.asarray(rec["tokens"], np.int64)
            else:
                req.error = RequestError(rec.get("code", rec["terminal"]),
                                         "delivered again after a restore")
            self.done.append(req)
        if self.model_axis is not None:
            self.model_axis.agree(json.dumps(self._scheduler_state()).encode(),
                                  "restore")
        return recovered

    def _scheduler_state(self) -> dict:
        """The host scheduler's state as plain data: the queue in order
        (uid, rank, retries, stream), the parks (uid, n, shard, chain
        keys), the slots' uids and the delivered uids."""
        order = sorted(self.queue.requests(),
                       key=lambda r: (r.priority, r.deadline_time, r._seq))
        return {"queue": [[int(r.uid), r._seq, int(r.retries), r.noise_seed]
                          for r in order],
                "parked": [[int(u), int(p.n), int(p.shard),
                            [int(k) for k in p.kv_keys]]
                           for u, p in sorted(self.parked.items())],
                "slots": [None if r is None else int(r.uid)
                          for r in self.slots],
                "done": [int(r.uid) for r in self.done]}

    def _reconcile_disk(self):
        """Keep on this rank's disk tier only the entries every model rank
        holds: each rank's names broadcast in turn, the rest dropped. The
        ranks' tiers then answer every later lookup alike."""
        axis = self.model_axis
        mine = sorted(self.disk.names()) if self.disk is not None else []
        common = None
        for src in range(axis.size):
            names = set(json.loads(axis.broadcast_bytes(
                json.dumps(mine).encode() if src == axis.rank else None,
                src=src)))
            common = names if common is None else common & names
        for name in mine:
            if name not in common:
                self.disk.drop(name)

    # -- telemetry -----------------------------------------------------------
    def export_metrics(self) -> dict:
        out = self.metrics.export(
            self.pool.stats_export(),
            self.tier.stats_export() if self.tier is not None else None)
        out["blocks_in_use"] = self.pool.blocks_in_use()
        out["blocks_available"] = self.pool.available()
        if self.topo.data_size > 1:
            out["blocks_available_by_shard"] = [
                self.pool.available(s) for s in range(self.topo.data_size)]
        out["parked_requests"] = len(self.parked)
        out["queue_depth"] = len(self.queue)
        out["staged_requests"] = len(self.staged)
        out["prefetched_requests"] = len(self._prefetched)
        # the tier's failure counters are present without a tier too
        out.setdefault("checksum_failures", 0)
        out.setdefault("tier_tripped", 0)
        out.setdefault("tier_state", "closed")
        out.setdefault("tier_denied_ops", 0)
        out["rounds_per_sync_final"] = (self.rounds_ctrl.k
                                        if self.staging_slots
                                        else self.rounds_per_sync)
        out["faults_injected"] = (self.faults.total_fired
                                  if self.faults is not None else 0)
        if self.faults is not None:
            out.update(self.faults.fired_export())
        # the disk breaker and the journal's counters where configured, the
        # disk's zero-filled otherwise
        if (self.disk is not None
                and (self.tier is None or self.tier.disk is None)):
            out.update(self.disk.stats_export())
        out.setdefault("disk_state", "closed")
        out.setdefault("disk_tripped", 0)
        out.setdefault("disk_hits", 0)
        out.setdefault("disk_promotes", 0)
        out.setdefault("disk_spills", 0)
        if self.journal is not None:
            out.update(self.journal.stats_export())
        return out


def fresh_stream_id(seq_id: int, poisoned=frozenset()) -> int:
    """The noise stream a quarantined request is retried on: the next step
    of the reference's LCG walk over 31-bit ids from ``seq_id`` that is
    neither 0 nor one of the ``poisoned`` streams."""
    seed = int(seq_id)
    while True:
        seed = (seed * 6364136223846793005 + 1442695040888963407) % 2 ** 31
        if seed not in poisoned and seed != 0:
            return seed
