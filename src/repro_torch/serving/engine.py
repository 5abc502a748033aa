"""`ServingEngine`: paged predictive-sampling serving on one device.

The port of the reference's ``serving/engine.py``, single-device:

* **Paged KV cache** — attention K/V (GQA) or the latent cache (MLA)
  lives in fixed-size blocks of a shared physical pool; verify rounds and
  prefill decode through the block tables (``decode_window_paged``). On
  the GPU every layer runs its fused paged-decode kernel (GQA or latent),
  which attends through the table and commits the window in the same
  launch; ``use_attention_kernel=False`` takes the gather-view fallback
  (writeback kernel, gathered view, plain attention).
* **Recurrent states** — RWKV-6 layers carry one state row per batch slot
  instead of KV blocks; rounds and prefill adopt the state at the accept
  point into the slot's row in place, on the GPU through the WKV kernel
  (``use_attention_kernel`` picks the mixers' kernels). A slot's row is
  zeroed when it is freed and when a request is admitted to it.
* **Prefix cache** — full prompt blocks are content-hashed (chained keys);
  admissions sharing a prompt prefix point their tables at the cached
  blocks and skip recomputing them. Off for stacks with recurrent layers,
  whose state after a prefix is not paged (the reference reaches it only
  through its host tier's snapshots, not ported).
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
* **Fault isolation** (the reference's DESIGN.md §14) — the engine fails
  per request, never per process: submit-time validation rejects a
  malformed request with a ``RequestError``; a per-row health flag in the
  packed stats (non-finite logits, stuck progress) quarantines only its
  slot, whose blocks are released while every other row stays bitwise
  what it would have been; an allocation fault at admission or while a
  table grows fails only the request that hit it. Up to
  ``request_retries`` retries requeue a failed request at its original
  rank, a quarantined one on a fresh noise stream; ``cancel(uid)`` removes
  a queued or running request; ``max_request_seconds`` and
  ``max_request_rounds`` bound runaways. A ``FaultPlan``
  (``serving/faults.py``; ``REPRO_FAULT_PLAN`` by default) scripts the
  faults: its ``alloc`` seam in ``BlockManager.alloc``, and its poisoned
  noise streams, whose logits ``verify_round`` replaces with NaN.

The pool and the per-slot row state (tokens, lengths, windows) are updated
in place: the reference donates them to each step, so their old values are
dead there too.

Exactness: every request's tokens equal a per-request
``PredictiveSampler.generate`` run with the same noise key and stream id
(``Request.seq_id``), retried ones included. Preemption, the host tier,
staged adoption, the journal and the mesh are later slices (ROADMAP.md §1
Slices C and F); so are the cancel of parked and staged requests and the
fault seams of those modules.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.engine.spec_decode import GenState, make_eps_fn, verify_round
from repro_torch.models.transformer import (PagedView, TransformerLM,
                                            has_recurrent)
from repro_torch.serving.adaptive import AdaptiveWindowController
from repro_torch.serving.admission import (AdmissionQueue, Request,
                                           pow2_at_most, prefill_chunks)
from repro_torch.serving.blocks import BlockManager
from repro_torch.serving.faults import FaultPlan, RequestError
from repro_torch.serving.metrics import EngineMetrics


class ServingEngine:
    def __init__(self, cfg, params, *, batch: int, window_max: int = 8,
                 max_len: int = 256, eps_key=0, eps_fn=None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 adaptive: bool = True, window_init: int = 0,
                 prefix_cache: bool = True, prefill_chunk: int = 64,
                 use_forecast_heads: bool = False,
                 use_verify_kernel: bool = False,
                 use_attention_kernel: Optional[bool] = None,
                 rounds_per_sync: int = 4, lookahead: int = 8,
                 max_head_bypass: int = 16, request_retries: int = 0,
                 max_request_seconds: Optional[float] = None,
                 max_request_rounds: Optional[int] = None,
                 faults: Optional[FaultPlan] = None, device=None):
        if block_size < 1 or window_max < 1 or rounds_per_sync < 1 \
                or prefill_chunk < 1 or lookahead < 1 or max_head_bypass < 0 \
                or request_retries < 0:
            raise ValueError("block_size, window_max, rounds_per_sync, "
                             "prefill_chunk and lookahead must be >= 1, "
                             "max_head_bypass and request_retries >= 0")
        self.device = resolve_device(device)
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
        # the fused paged kernel on the GPU; the gather-view fallback on the
        # CPU, which is exact against the dense solo sampler
        if use_attention_kernel is None:
            use_attention_kernel = self.device.type == "cuda"
        self.use_attention_kernel = use_attention_kernel
        self.rounds_per_sync = rounds_per_sync
        self.lookahead = lookahead
        self.max_head_bypass = max_head_bypass
        self.request_retries = request_retries
        self.max_request_seconds = max_request_seconds
        self.max_request_rounds = max_request_rounds
        self.faults = faults if faults is not None else FaultPlan.from_env()
        self.eps_fn = eps_fn if eps_fn is not None else make_eps_fn(
            eps_key, cfg.vocab)

        # ---- paged cache ------------------------------------------------
        self.nb = -(-(max_len + window_max) // block_size)  # table width
        if num_blocks is None:
            # full occupancy + slack so unreferenced prefix blocks survive
            num_blocks = 1 + batch * self.nb + 2 * self.nb
        self.pool = BlockManager(num_blocks, block_size)
        if self.faults is not None:
            self.pool.fault_hook = lambda: self.faults.fire("alloc")
        self.paged = TransformerLM.init_paged_cache(
            cfg, batch, num_blocks, block_size, dtype=cfg.param_dtype,
            device=self.device)
        self.tables = np.zeros((batch, self.nb), np.int32)
        self.owned: list[list[int]] = [[] for _ in range(batch)]
        # a prefix hit would skip the recurrent state's prefill
        self.kv_prefix = prefix_cache and not has_recurrent(cfg)

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
        self.n_host = np.ones(batch, np.int64)
        self._last_rounds_exec = 0

        # ---- per-slot device state (updated in place) --------------------
        dev = self.device
        self.tokens = torch.zeros((batch, max_len), dtype=torch.int64,
                                  device=dev)
        self.n = torch.ones((batch,), dtype=torch.int64, device=dev)
        # ^ cleared-row sentinel n=1
        self.cand = torch.zeros((batch, window_max), dtype=torch.int64,
                                device=dev)
        self.seq_ids = np.zeros(batch, np.int64)
        # 1 where the slot's noise stream is one of the fault plan's
        # poisoned streams: its logits are NaN-replaced every round
        self.poison = np.zeros(batch, np.int64)
        # device copies of host-owned admission state, re-uploaded only
        # after the host changes them
        self._tables_dev = None
        self._target_dev = None
        self._seq_dev = None
        self._poison_dev = None

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
        cap = self.pool.num_blocks - 1            # minus the reserved sink
        if self._worst_case_blocks(req) > cap:
            return RequestError(
                "over_capacity", f"worst case {self._worst_case_blocks(req)}"
                f" blocks > pool capacity {cap}")
        return None

    def submit(self, req: Request) -> bool:
        """Validate and enqueue. Returns False — with ``req.error`` set and
        the request delivered through ``done`` — on rejection."""
        err = self._validate(req)
        if err is not None:
            req.error = err
            req.submit_time = time.monotonic()
            req.finish_time = req.submit_time
            self.metrics.requests_rejected += 1
            self.done.append(req)
            return False
        self.queue.push(req)
        return True

    # -- device steps -------------------------------------------------------
    def _prefill(self, table_row, b: int, chunk, start: int):
        """Row-local prefill of one chunk through slot ``b``'s block table;
        the pool is written in place and the slot's recurrent row takes the
        state after the chunk's last token."""
        view = PagedView(table_row, slice(b, b + 1),
                         self.use_attention_kernel)
        _, _, nc = TransformerLM.decode_window_paged(
            self.params, self.cfg, chunk, self.paged, view,
            torch.tensor([start], dtype=torch.int32, device=self.device),
            last_state_only=True)
        TransformerLM.adopt_states_paged(self.cfg, self.paged, nc, view.rows)

    def _round_loop(self, W: int, k: int) -> torch.Tensor:
        """Up to ``k`` verify rounds at window W on the device, with no host
        sync inside. A round runs while some row is live (not done, not
        bad); after that every round is a no-op (its target is zeroed, so no
        row is active), the work the reference's ``while_loop`` skips.
        Returns the packed (B, 5) stats ``[accepted, rounds_active,
        new_length, loop_rounds, bad]``."""
        B, dev = self.B, self.device
        tables, seq_ids = self._tables_device(), self._seq_device()
        target = self._target_device()
        # every row's logits pass through untouched where no slot holds a
        # poisoned stream, so the select over them is left out
        poison = self._poison_device() if self.poison.any() else None
        view = PagedView(tables, slice(0, B), self.use_attention_kernel)
        tokens, n, cand = self.tokens, self.n, self.cand
        zero = torch.zeros((B,), dtype=torch.int64, device=dev)
        acc, act_rounds, bad = zero, zero, zero
        r = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(k):
            live = ((n < target) & (bad == 0)).any()
            tgt = torch.where(live, target, zero)
            active = (n < tgt).long()
            st = GenState(tokens, n, cand[:, :W], self.paged, r, zero, zero,
                          seq_ids)
            st2, rstats = verify_round(
                self.params, self.cfg, self.eps_fn, st, tgt,
                use_forecast_heads=self.use_forecast_heads,
                use_verify_kernel=self.use_verify_kernel, paged=view,
                poison=poison)
            # sticky health bits: 1 = non-finite logits, 2 = no progress
            stuck = active * (st2.n == n).long()
            bad = bad | (active * rstats[:, 3]) | (stuck << 1)
            acc = acc + rstats[:, 0]
            act_rounds = act_rounds + active
            r = r + live.long()
            self.metrics.verify_passes += 1
            tokens, n = st2.tokens, st2.n
            cand = torch.cat([st2.cand, torch.zeros_like(cand[:, W:])], dim=1)
        self.tokens.copy_(tokens)
        self.n.copy_(n)
        self.cand.copy_(cand)
        return torch.stack([acc, act_rounds, n, r.expand(B), bad], dim=1)

    # -- slot / block plumbing ---------------------------------------------
    def _ensure_capacity(self, b: int, upto_pos: int):
        """Grow slot ``b``'s block table to cover positions [0, upto_pos)."""
        need = -(-upto_pos // self.block_size)
        assert need <= self.nb, (need, self.nb)
        while len(self.owned[b]) < need:
            blk = self.pool.alloc(1)[0]
            self.tables[b, len(self.owned[b])] = blk
            self.owned[b].append(blk)
            self._tables_dev = None

    def _clear_row(self, b: int):
        """Release slot ``b`` and reset its row to the inactive no-op lane:
        n=1, cache_len=0, an all-zero table (sink block 0)."""
        self.pool.release_all(self.owned[b])
        self.owned[b] = []
        self.tables[b] = 0
        self.target[b] = 0
        self.reserved[b] = 0
        self.n_host[b] = 1
        self.seq_ids[b] = 0
        self.poison[b] = 0
        self._tables_dev = self._target_dev = self._seq_dev = None
        self._poison_dev = None
        self.tokens[b] = 0
        self.n[b] = 1
        self.cand[b] = 0
        TransformerLM.reset_rows(self.cfg, self.paged, b)

    def _tables_device(self):
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self.tables.copy()).to(
                self.device)
        return self._tables_dev

    def _target_device(self):
        if self._target_dev is None:
            self._target_dev = torch.from_numpy(self.target.copy()).to(
                self.device)
        return self._target_dev

    def _seq_device(self):
        if self._seq_dev is None:
            self._seq_dev = torch.from_numpy(self.seq_ids.copy()).to(
                self.device)
        return self._seq_dev

    def _poison_device(self):
        if self._poison_dev is None:
            self._poison_dev = torch.from_numpy(self.poison.copy()).to(
                self.device)
        return self._poison_dev

    def _set_poison(self, b: int, req: Request):
        """Slot ``b``'s poison entry for its new occupant."""
        v = int(self.faults is not None
                and req.seq_id in self.faults.poison_streams)
        if int(self.poison[b]) != v:
            self.poison[b] = v
            self._poison_dev = None

    # -- admission ----------------------------------------------------------
    def _worst_case_blocks(self, req: Request) -> int:
        # every prompt+generation block a fresh allocation, window at W_max
        return -(-(len(req.prompt) + req.new_tokens + self.W_max)
                 // self.block_size)

    def _headroom(self) -> int:
        """Free blocks net of those promised to in-flight slots but not yet
        allocated (their tables grow lazily as n advances)."""
        owed = sum(max(0, int(self.reserved[b]) - len(self.owned[b]))
                   for b in range(self.B) if self.slots[b] is not None)
        return self.pool.available() - owed

    def _route(self, req: Request) -> Optional[int]:
        """The lowest free slot, iff the pool covers the request's worst
        case."""
        free = [b for b in range(self.B) if self.slots[b] is None]
        if not free or self._headroom() < self._worst_case_blocks(req):
            return None
        return free[0]

    def _admit_pending(self):
        """Lookahead admission: scan up to ``lookahead`` queued requests in
        queue order and admit the first routable one; every admission that
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
        req.admit_time = time.monotonic()
        prompt = np.asarray(req.prompt, np.int64)
        L_p = len(prompt)
        # prefix cache: reuse full blocks strictly below position L_p - 1
        # (the verify window rewrites position n-1 = L_p-1 onward, so those
        # blocks stay read-only and shareable)
        hits, keys = [], []
        nb_full = (L_p - 1) // self.block_size
        if self.kv_prefix and nb_full:
            hits, keys = self.pool.lookup_prefix(prompt, nb_full)
        self.owned[b] = list(hits)
        self.tables[b] = 0
        self.tables[b, :len(hits)] = hits
        self._tables_dev = None
        self._ensure_capacity(b, L_p)
        req.prefix_hit_blocks = len(hits)

        dev = self.device
        row_tokens = torch.zeros((self.max_len,), dtype=torch.int64)
        row_tokens[:L_p] = torch.from_numpy(prompt)
        self.tokens[b] = row_tokens.to(dev)
        self.n[b] = L_p
        self.cand[b] = 0
        self.cand[b, 0] = int(prompt[-1])
        self.seq_ids[b] = req.seq_id
        self._seq_dev = None

        # chunked row-local prefill of the un-cached prompt tail, from the
        # zero state
        TransformerLM.reset_rows(self.cfg, self.paged, b)
        start = len(hits) * self.block_size
        table_row = torch.from_numpy(self.tables[b:b + 1].copy()).to(dev)
        for C in prefill_chunks(L_p - 1 - start, self.prefill_chunk):
            chunk = torch.from_numpy(prompt[None, start:start + C]).to(dev)
            self._prefill(table_row, b, chunk, start)
            start += C
            req.prefill_calls += 1
            self.metrics.prefill_calls += 1
        # publish this prompt's freshly computed full blocks
        if self.kv_prefix:
            for j in range(len(hits), nb_full):
                self.pool.register(self.owned[b][j], keys[j])

        self.slots[b] = req
        self._set_poison(b, req)
        self.target[b] = L_p + req.new_tokens
        self._target_dev = None
        self.reserved[b] = self._worst_case_blocks(req)
        self.n_host[b] = L_p

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
            return
        req.error = RequestError(code, detail, retryable=retryable,
                                 attempts=req.retries + 1)
        req.result = None
        req.finish_time = time.monotonic()
        self.metrics.requests_failed += 1
        self.done.append(req)

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
        """Cancel a queued or running request. It finishes through ``done``
        with ``error.code == "cancelled"``; a running one's slot is freed
        at once, which leaves the other rows exactly as they were. Returns
        False for an unknown ``uid`` (finished, or never submitted)."""
        for req in self.queue.requests():
            if req.uid == uid:
                self.queue.remove(req)
                self._finalize_cancel(req)
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
        req.finish_time = time.monotonic()
        self.metrics.requests_cancelled += 1
        self.done.append(req)

    # -- main loop -----------------------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:
        """Admit what fits, run one loop of up to ``rounds_per_sync`` verify
        rounds (one round while requests are queued, so freed slots refill
        promptly), harvest finished requests. The host pulls exactly one
        small stats array per step. Returns True while there is work."""
        self._admit_pending()
        if not any(s is not None for s in self.slots):
            if self.queue:
                raise MemoryError(
                    "admission deadlock: queued request cannot fit an empty "
                    "engine (prompt+target exceeds the block pool)")
            return False
        W = self.controller.window
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
            return bool(self.queue)
        # THE host sync: one small packed pull per loop
        stats = self._round_loop(W, k).cpu().numpy()
        accepted, rounds_active, n_host = stats[:, 0], stats[:, 1], stats[:, 2]
        bad = stats[:, 4]
        rounds_exec = int(stats[:, 3].max())
        self.n_host[:] = n_host
        self._last_rounds_exec = rounds_exec

        now = time.monotonic()
        slot_rows = [b for b in range(self.B) if self.slots[b] is not None]
        for b in slot_rows:
            self.slots[b].calls_used += int(rounds_active[b])
        act_row_rounds = int(rounds_active[slot_rows].sum())
        acc_total = int(accepted[slot_rows].sum())
        self.metrics.observe_loop(W, rounds_exec, act_row_rounds, self.B,
                                  acc_total)
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
                req.result = self.tokens[b, :n_host[b]].cpu().numpy().copy()
                req.finish_time = now
                self.metrics.observe_finish(req)
                self.done.append(req)
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
        return True

    def run(self, max_rounds: int = 10_000) -> list[Request]:
        """Drain the queue; returns completed Requests. ``max_rounds``
        bounds executed verify rounds."""
        budget = int(max_rounds)
        while self.queue or any(s is not None for s in self.slots):
            if not self.step():
                break
            budget -= self._last_rounds_exec
            if budget <= 0 and (self.queue or any(
                    s is not None for s in self.slots)):
                raise RuntimeError(
                    f"serving engine did not converge within {max_rounds} "
                    "verify rounds")
        return self.done

    # -- telemetry -----------------------------------------------------------
    def export_metrics(self) -> dict:
        out = self.metrics.export(self.pool.stats.export())
        out["blocks_in_use"] = self.pool.blocks_in_use()
        out["blocks_available"] = self.pool.available()
        out["queue_depth"] = len(self.queue)
        out["rounds_per_sync_final"] = self.rounds_per_sync
        out["faults_injected"] = (self.faults.total_fired
                                  if self.faults is not None else 0)
        if self.faults is not None:
            out.update(self.faults.fired_export())
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
