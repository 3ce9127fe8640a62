"""Metric names, bytes-on-wire accounting, throughput and MFU.

The port of ``photon_tpu/utils/profiling.py`` minus its ``jax.profiler``
helpers: the whole name registry (KPI, span, event, instrument and alert
names: the same strings, so a History, a trace or a scrape reads the same
in both packages), :func:`registered_metric_names` /
:func:`is_registered_metric`, :class:`WireStats`, :func:`is_oom`, the
FLOP count per token and :class:`SpeedMonitor`. The registry also names
the JAX package's planes the port does not run yet (collective, async,
autopilot), so a config or a scrape of either package finds its names
here. :func:`model_flops_per_token` keeps the JAX formula unchanged, so
an MFU means the same in both packages; note that its attention term
``12 L d s`` counts the full (non-causal) score and value products. The
peak comes from the CUDA device's name (H100: 989e12 bf16 dense, NVIDIA's
data sheet); for any other device, the CPU included, no MFU is reported.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
import sys

from photon_tpu_torch.config.schema import ModelConfig

# ---------------------------------------------------------------------------
# KPI name registry: every ``server/*`` / ``client/*``
# metric name the runtime records into History is declared HERE as a module
# constant — record sites import the constant, a registry test
# (tests/test_torch_telemetry.py) asserts no stringly-typed name drifts past this
# file, and the tracing plane reuses the same constants as span names so
# KPIs and spans agree on vocabulary.
# ---------------------------------------------------------------------------

# -- server round-loop phases (federation/server.py) ----------------------
ROUND_TIME = "server/round_time"
FIT_ROUND_TIME = "server/fit_round_time"
BROADCAST_PRE_TIME = "server/broadcast_pre_time"
BROADCAST_POST_TIME = "server/broadcast_post_time"
CHECKPOINT_TIME = "server/checkpoint_time"
CKPT_BARRIER_WAIT_S = "server/ckpt_barrier_wait_s"
STEPS_CUMULATIVE = "server/steps_cumulative"
ROUND_FAILED = "server/round_failed"
EVAL_ROUND_FAILED = "server/eval_round_failed"
# span-only phase names (no KPI twin: the KPI would duplicate round_time
# decomposition already carried by the spans)
SAMPLE_CLIENTS_SPAN = "server/sample_clients"
EVAL_ROUND_SPAN = "server/eval_round"
# whole-unit umbrella spans: deliberately NOT the KPI names — the KPI
# server/round_time is measured from fit_round entry (excludes broadcast/
# eval/checkpoint) and client/fit_time is the train loop alone, while these
# spans cover the full round / full fit. A span may share a KPI's name ONLY
# when it measures the same window.
ROUND_SPAN = "server/round"
CLIENT_FIT_SPAN = "client/fit"

# -- server aggregation / strategy (strategy/base.py, metrics.py) ---------
N_CLIENTS = "server/n_clients"
N_SAMPLES = "server/n_samples"
EFFECTIVE_LR = "server/effective_lr"
EVAL_LOSS = "server/eval_loss"
EVAL_SAMPLES = "server/eval_samples"
PSEUDO_GRAD_NORM = "server/pseudo_grad_norm"
PARAM_NORM = "server/param_norm"
GNS_TRACE_EST = "server/gns_trace_est"
GNS_SQNORM_EST = "server/gns_sqnorm_est"
GRADIENT_NOISE_SCALE = "server/gradient_noise_scale"
COLLECTIVE_AGG_TIME = "server/collective_agg_time"

# -- device-resident aggregation plane (parallel/collective_agg.py) -------
# Hierarchy stage decomposition of COLLECTIVE_AGG_TIME (which spans all
# three), recorded per round by CollectiveFedRunner:
#: host rows → client-axis-sharded device arrays (stack + device_put)
COLLECTIVE_STACK_TIME = "server/collective_stack_time"
#: the fused SPMD program: hierarchical reduce (+ q8 codec) + server update
COLLECTIVE_EXCHANGE_TIME = "server/collective_exchange_time"
#: replicated result → host (broadcast/checkpoint mirror fetch; on the
#: host-optimizer path also the host strategy update itself)
COLLECTIVE_UPDATE_TIME = "server/collective_update_time"
#: modeled cross-slice DCN bytes this round (idealized once-across model,
#: ``collective_agg.modeled_cross_slice_bytes`` — the fp32-vs-q8 ratio is
#: the number that matters, not the absolute)
COLLECTIVE_WIRE_BYTES = "server/collective_wire_bytes"
#: q8 encode+decode seconds, measured OUT-OF-LINE by ``bench.py
#: --collective`` (inside the round the codec is fused into the exchange
#: program and cannot be timed separately)
COLLECTIVE_QUANT_TIME = "server/collective_quant_time"

# -- elastic collective rounds (federation/collective_round.py) --
#: clients missing from this round's surviving cohort (failed fits +
#: liveness-excluded); 0 every round on a fault-free run
COLLECTIVE_STRAGGLERS = "server/collective_stragglers"
#: 1.0 when this round degraded to the host-plane ``aggregate_inplace``
#: fold (below quorum / retry budget exhausted), else 0.0 — the runner
#: keeps the cumulative count on ``degraded_rounds_total``
COLLECTIVE_DEGRADED_ROUNDS = "server/collective_degraded_rounds"
#: seconds spent reconfiguring the gang this round (survivor-cohort mesh
#: rebuild + re-run attempts after a missed stage deadline); 0.0 when the
#: first attempt lands
COLLECTIVE_RECONFIG_TIME = "server/collective_reconfig_time"

# -- ZeRO-1 sharded server update + layout auto-tuner ----------
#: per-rank fraction of the full server state (params + optimizer moments)
#: resident on the device plane: 1.0 replicated, ≈1/replica on the ZeRO-1
#: sharded plane (chunk padding makes it marginally larger)
OPT_SHARD_FRAC = "server/opt_shard_frac"
#: wall seconds of the post-update params ICI all-gather + host fetch (the
#: ONE all-gather of a sharded round — it runs after the update, inside
#: the update leg; 0.0 on the replicated plane, where params never shard)
OPT_ALLGATHER_TIME = "server/opt_allgather_time"
#: wall seconds the layout auto-tuner (parallel/autotune.py) spent
#: enumerating + ranking (data, fsdp, tensor, pipe) meshes for this
#: client's device slice
LAYOUT_SEARCH_TIME = "server/layout_search_time"
#: the auto-tuner's analytic step-time estimate for the layout it picked
#: (compare against the measured step time to audit the cost model)
LAYOUT_EST_STEP_S = "server/layout_est_step_s"

# -- asynchronous federated rounds (federation/async_round.py) --
# Version-clock KPIs recorded by AsyncFedRunner into History at each
# version advance (the async analog of the per-round KPI block above):
#: the server version after this advance (the monotone version clock)
ASYNC_VERSION = "server/async_version"
#: client deltas folded into this advance (== the K buffer unless a
#: same-instant burst advanced multiple versions at once)
ASYNC_ARRIVALS = "server/async_arrivals"
#: mean / max staleness (server_version − client_base_version) across the
#: deltas folded this advance; 0 everywhere == the synchronous round
ASYNC_STALENESS_MEAN = "server/async_staleness_mean"
ASYNC_STALENESS_MAX = "server/async_staleness_max"
#: mean staleness-discount weight multiplier applied this advance (1.0 at
#: zero staleness — the bit-parity regime)
ASYNC_DISCOUNT_MEAN = "server/async_discount_mean"
#: cumulative deltas rejected for staleness > max_staleness (each gets a
#: fresh-version re-broadcast, never an aborted run)
ASYNC_REJECTED = "server/async_rejected_total"
#: cumulative in-flight deltas dropped on a LivenessTracker dead edge
ASYNC_DROPPED = "server/async_dropped_total"
#: cumulative buffer-full moments where < min_arrivals distinct clients
#: had landed — the version clock held still (stall, not abort)
ASYNC_STALLS = "server/async_stalls_total"
#: buffered deltas awaiting the next advance, sampled after each arrival
ASYNC_BUFFER_FILL = "server/async_buffer_fill"
#: simulated seconds elapsed when this version committed — the modeled
#: wall clock ``bench.py --async`` measures time-to-target-loss on
ASYNC_SIM_TIME = "server/async_sim_time"
#: the chaos fit_delay_plan slowdown factor this fit ran under (1.0 =
#: no injected skew; the async runner scales simulated durations by it)
CLIENT_FIT_DELAY_FACTOR = "client/fit_delay_factor"

# -- wire / compression plane (WireStats.metrics_since) -------------------
WIRE_UPLINK_RAW_BYTES = "server/wire_uplink_raw_bytes"
WIRE_UPLINK_BYTES = "server/wire_uplink_bytes"
WIRE_BROADCAST_BYTES = "server/wire_broadcast_bytes"
WIRE_COMPRESSION_RATIO = "server/wire_compression_ratio"

# -- client-side KPIs (train/trainer.py, federation/client_runtime.py) ----
CLIENT_FIT_TIME = "client/fit_time"
CLIENT_FIT_INIT_TIME = "client/fit_init_time"
CLIENT_FIT_SET_PARAMETERS_TIME = "client/fit_set_parameters_time"
CLIENT_STEPS = "client/steps"
CLIENT_TOKENS_PER_SEC = "client/tokens_per_sec"
CLIENT_FINAL_LOSS = "client/final_loss"
CLIENT_LR = "client/lr"
CLIENT_PSEUDO_GRAD_NORM = "client/pseudo_grad_norm"
CLIENT_PARAM_NORM = "client/param_norm"
CLIENT_SKIPPED_ROUND = "client/skipped_round"
# span-only client phases (telemetry plane)
CLIENT_RESOLVE_PARAMS_SPAN = "client/resolve_params"
CLIENT_TRAIN_SPAN = "client/train"
CLIENT_ENCODE_SPAN = "client/encode"
CLIENT_PACKAGE_SPAN = "client/package"
CLIENT_EVALUATE_SPAN = "client/evaluate"

# -- transport-leg span names (federation/tcp.py; spans only, never KPIs) --
TCP_SEND_SPAN = "tcp/send"
TCP_RECV_SPAN = "tcp/recv"

# -- serving plane (photon_tpu/serve) ----------------------------
# KPIs the continuous batcher records into its own History (exported via
# telemetry/prom.py's exposition renderer on the frontend's /metrics):
#: seconds from request admission-queue entry to its FIRST streamed token
SERVE_TTFT_S = "serve/ttft_s"
#: decoded tokens/sec across the slot batch over the last scheduler tick
SERVE_TOKENS_PER_S = "serve/tokens_per_s"
#: admission-queue depth at tick time (backpressure: full queue → HTTP 429)
SERVE_QUEUE_DEPTH = "serve/queue_depth"
#: fraction of decode slots occupied at tick time
SERVE_SLOT_OCCUPANCY = "serve/slot_occupancy"
#: cumulative finished sequences evicted from slots (EOS / length cap)
SERVE_EVICTIONS = "serve/evictions"
#: cumulative requests rejected at admission (queue full → 429)
SERVE_REJECTED = "serve/rejected"
# span-only request phases (telemetry plane): the per-request umbrella and
# its queue/prefill/decode children, emitted at request completion
SERVE_REQUEST_SPAN = "serve/request"
SERVE_QUEUE_SPAN = "serve/queue"
SERVE_PREFILL_SPAN = "serve/prefill"
SERVE_DECODE_SPAN = "serve/decode"

# -- multi-tenant serving daemon (serve/prefix.py + hotswap.py) --
# Content-addressed prefix cache (tick-time gauges/counters recorded into
# the batcher History AND mirrored onto the typed hub):
#: fraction of cumulative prompt tokens served out of the prefix cache
#: (cached full-block tokens / all submitted prompt tokens)
SERVE_PREFIX_HIT_RATE = "serve/prefix_hit_rate"
#: physical blocks currently indexed by the prefix cache (each holds one
#: allocator reference; shared CoW blocks in live use count here too)
SERVE_PREFIX_SHARED_BLOCKS = "serve/prefix_shared_blocks"
#: cumulative cache entries dropped (LRU pressure + explicit flushes)
SERVE_PREFIX_EVICTIONS = "serve/prefix_evictions"
#: cumulative prompt tokens whose prefill was skipped via a cache hit
SERVE_PREFIX_TOKENS_CACHED = "serve/prefix_tokens_cached_total"
# Live checkpoint hot-swap (serve/hotswap.py watcher + scheduler swap point):
#: cumulative parameter swaps applied at the scheduler swap point
SERVE_HOTSWAP_SWAPS_TOTAL = "serve/hotswap_swaps_total"
#: seconds from swap request to the reference assignment landing (the
#: quiesce window: running slots finishing on the old params)
SERVE_HOTSWAP_SWAP_LATENCY_S = "serve/hotswap_swap_latency_s"
#: candidate rounds the watcher refused because their manifest checksums
#: failed (the corrupt round is skipped-and-warned, never swapped)
SERVE_HOTSWAP_REJECTED_CORRUPT = "serve/hotswap_rejected_corrupt_total"
#: the server round currently being served (moves on a successful swap)
SERVE_HOTSWAP_ROUND = "serve/hotswap_round"
# span-only: the swap window (request → reference assignment)
SERVE_HOTSWAP_SWAP_SPAN = "serve/hotswap_swap"

# -- ragged paged attention + chunked prefill ------------------
# Attention-plane gauges (tick-time, from PagedEngine.attn_stats):
#: the live attention walk width in BLOCKS (the monotone high-water
#: pow2 bucket; == the full table width under attention_impl=gather)
SERVE_ATTN_CTX_BLOCKS = "serve/attn_ctx_blocks"
#: fraction of the paged pool's blocks currently allocated (live KV —
#: the x-axis of the bench's tokens/s-vs-occupancy curve)
SERVE_ATTN_LIVE_FRAC = "serve/attn_live_frac"
#: 1.0 when the ragged live-block walk is active, 0.0 under the
#: full-width dense-gather oracle path (attention_impl=gather)
SERVE_ATTN_RAGGED = "serve/attn_ragged"
# Chunked-prefill counters (scheduler-owned, cumulative):
#: scheduler steps that carried a prompt chunk alongside decode rows
SERVE_CHUNK_STEPS = "serve/chunk_steps_total"
#: prompt tokens prefilled through the chunk stream
SERVE_CHUNK_TOKENS = "serve/chunk_tokens_total"
#: prompts that needed more than one chunk (suffix > the per-step
#: token budget — the giant prompts that used to monopolize a step)
SERVE_CHUNK_SPLIT_PROMPTS = "serve/chunk_split_prompts_total"

# -- speculative decoding (serve/draft.py) -----------------------
# Draft-and-verify counters (scheduler-owned, cumulative):
#: draft tokens proposed to the verification grid
SERVE_SPEC_DRAFTED = "serve/spec_drafted_total"
#: draft tokens the model accepted (longest-matching-prefix for greedy,
#: rejection-sampling for temperature rows)
SERVE_SPEC_ACCEPTED = "serve/spec_accepted_total"
#: scheduler steps that carried at least one drafted row
SERVE_SPEC_STEPS = "serve/spec_steps_total"
# Tick-time gauges:
#: the accept-rate EWMA driving the auto-throttle (1.0 = every draft lands)
SERVE_SPEC_ACCEPT_RATE = "serve/spec_accept_rate"
#: the throttle's current per-row draft depth K (0 = plain decode)
SERVE_SPEC_K = "serve/spec_k"

# -- per-cohort LoRA personalization plane (photon_tpu/adapters) --
# Train side (federation/collective_round.py grouped rounds):
#: cohorts whose adapters updated this round (fused grouped reduction OR
#: the per-cohort host fold on the degraded path)
ADAPTER_COHORTS = "server/adapter_cohorts"
#: configured cohorts with ZERO surviving members this round — their
#: adapters stayed untouched (per-cohort degradation: one cohort's dead
#: clients never cost another cohort its round)
ADAPTER_COHORTS_DEGRADED = "server/adapter_cohorts_degraded"
#: modeled cross-slice bytes of this round's ADAPTER exchange (the
#: ~1000x-under-full-model number the personalization plane exists for;
#: equals server/collective_wire_bytes on adapter rounds)
ADAPTER_WIRE_BYTES = "server/adapter_wire_bytes"
# Serve side (serve/adapter_pool.py, tick-time from engine.adapter_stats):
#: adapter pages currently resident on device
SERVE_ADAPTER_RESIDENTS = "serve/adapter_residents"
#: cohorts in the host bank (servable cohorts)
SERVE_ADAPTER_COHORTS = "serve/adapter_cohorts"
#: cumulative host→device page loads (cohort misses)
SERVE_ADAPTER_LOADS = "serve/adapter_loads_total"
#: cumulative page evictions (LRU pressure on the pool)
SERVE_ADAPTER_EVICTIONS = "serve/adapter_evictions_total"
#: fraction of cohort acquisitions served by a resident page
SERVE_ADAPTER_HIT_RATE = "serve/adapter_hit_rate"

# -- fleet router (serve/router.py + serve/fleet.py) ------------
# Router-tier KPIs recorded into the router's own History (exported via the
# same exposition renderer on the router's /metrics):
#: cumulative /generate requests the router accepted for routing
ROUTER_REQUESTS_TOTAL = "router/requests_total"
#: requests placed by the chain-hash prefix-affinity key
ROUTER_ROUTED_PREFIX = "router/routed_prefix_total"
#: requests placed by the sticky cohort pin
ROUTER_ROUTED_COHORT = "router/routed_cohort_total"
#: requests placed by the power-of-two-choices queue-depth fallback
ROUTER_ROUTED_P2C = "router/routed_p2c_total"
#: requests re-placed on a survivor after a connect failure (never after
#: response bytes started flowing — those surface to the client)
ROUTER_REROUTES = "router/reroutes_total"
#: cumulative proxy legs that failed outright (no survivor accepted)
ROUTER_PROXY_ERRORS = "router/proxy_errors_total"
#: replicas the liveness ladder currently counts live / suspect / dead
ROUTER_REPLICAS_LIVE = "router/replicas_live"
ROUTER_REPLICAS_SUSPECT = "router/replicas_suspect"
ROUTER_REPLICAS_DEAD = "router/replicas_dead"
#: cumulative cohort pins moved off a dead replica onto a survivor
ROUTER_COHORT_REPINS = "router/cohort_repins_total"
# Fleet-supervisor KPIs (serve plane vocabulary — the replicas are serve
# daemons; the supervisor aggregates):
#: replica daemons the supervisor currently manages
SERVE_FLEET_REPLICAS = "serve/fleet_replicas"
#: cumulative one-at-a-time rolling hot-swap passes across the fleet
SERVE_FLEET_ROLLING_SWAPS = "serve/fleet_rolling_swaps_total"

# -- run-health observatory instruments (telemetry/metrics.py) --
# Histogram instruments on the serve plane (typed-metric hub, NOT History
# KPIs: a latest-value gauge can't show a distribution):
#: seconds per OUTPUT token after the first (decode cadence; the serving
#: latency number TTFT doesn't cover)
SERVE_TPOT_S = "serve/tpot_s"
#: seconds a request waited in the admission queue before a slot opened
SERVE_QUEUE_WAIT_S = "serve/queue_wait_s"

# Device-plane introspection KPIs (telemetry/introspect.py), sampled at
# round boundaries (server/*) and serve-tick boundaries (serve/*):
#: live device (HBM) bytes on the first local device
HBM_BYTES_IN_USE = "server/hbm_bytes_in_use"
#: peak device bytes since process start
HBM_PEAK_BYTES = "server/hbm_peak_bytes"
#: cumulative backend compiles this process (program-cache misses are
#: visible as this counter moving in steady state)
COMPILES_TOTAL = "server/backend_compiles_total"
SERVE_HBM_BYTES_IN_USE = "serve/hbm_bytes_in_use"
SERVE_HBM_PEAK_BYTES = "serve/hbm_peak_bytes"
SERVE_COMPILES_TOTAL = "serve/backend_compiles_total"

# Instrument-only names (never History KPIs): transport frame sizes and
# the observability-of-the-observability drop counter.
#: TCP control-plane frame bytes, send leg (histogram)
TCP_SEND_BYTES = "tcp/send_bytes"
#: TCP control-plane frame bytes, recv leg (histogram)
TCP_RECV_BYTES = "tcp/recv_bytes"
#: spans discarded by the bounded tracer buffer (counter; also the kind of
#: the once-per-run warning event emitted on the first drop)
SPANS_DROPPED = "telemetry/spans_dropped"

# -- structured event kinds (telemetry/events.py JSONL log) ---------------
# Event names are registry constants for the same reason KPI/span names
# are: photon-lint's kpi-registry rule flags any string literal at an
# emit_event site, so a typo'd event kind can't silently fork the
# vocabulary consumers (export.py, dashboards) query by.
#: every LivenessTracker state-machine edge, incl. first registration
EVENT_MEMBERSHIP_TRANSITION = "membership/transition"
#: node agent redialed the server (supervisor loop, federation/tcp.py)
EVENT_TCP_RECONNECT = "tcp/reconnect"
#: CRC32 frame-check failure tore a connection down
EVENT_TCP_CORRUPT_FRAME = "tcp/corrupt_frame"
#: SpeedMonitor resolved its bf16 peak (device_kind + basis for MFU)
EVENT_SPEED_MONITOR_PEAK = "speed_monitor/peak"
#: a collective participant missed a stage deadline / failed its fit and
#: was dropped from the round's cohort
EVENT_COLLECTIVE_STRAGGLER = "collective/straggler"
#: the gang was rebuilt over the surviving cohort mid-round
EVENT_COLLECTIVE_RECONFIG = "collective/reconfig"
#: the round degraded to the host-plane aggregate_inplace fold
EVENT_COLLECTIVE_DEGRADED = "collective/degraded"
#: fault-injector firings are ``chaos/<plan kind>`` (chaos/injector.py
#: counters: tcp_drop, store_bitflip, crash, ...)
CHAOS_EVENT_PREFIX = "chaos/"
#: a configured adapter cohort had no surviving member this round — its
#: adapter skipped the update while every other cohort proceeded
EVENT_ADAPTER_COHORT_DEGRADED = "adapter/cohort_degraded"
#: the hot-swap watcher applied a new round's params
EVENT_HOTSWAP_SWAPPED = "hotswap/swapped"
#: the watcher skipped a candidate round (corrupt manifest, failing
#: federation health, or a poll landing during drain) — attrs say which
EVENT_HOTSWAP_SKIPPED = "hotswap/skipped"
#: a replica registered with the fleet router (HELLO + fleet_report)
EVENT_FLEET_REPLICA_UP = "fleet/replica_up"
#: the liveness ladder declared a replica dead; its cohorts re-pin
EVENT_FLEET_REPLICA_DEAD = "fleet/replica_dead"
#: a cohort's sticky pin moved to a survivor (attrs: cohort, from, to)
EVENT_FLEET_COHORT_REPIN = "fleet/cohort_repin"
#: one replica finished its leg of a rolling hot-swap pass
EVENT_FLEET_ROLLING_SWAP = "fleet/rolling_swap"
#: async server advanced its version clock (attrs: version, arrivals,
#: staleness_max — the analog of a completed round)
EVENT_ASYNC_VERSION = "async/version_advance"
#: a delta arrived staler than max_staleness and was rejected; the client
#: was re-dispatched from a fresh version (attrs: cid, staleness)
EVENT_ASYNC_REJECT = "async/stale_reject"
#: a LivenessTracker dead edge dropped a client's in-flight delta before
#: it could fold (attrs: cid)
EVENT_ASYNC_DROP = "async/delta_dropped"
#: the buffer filled but < min_arrivals distinct clients had landed — the
#: version clock held (stall-not-abort; attrs: buffered, distinct)
EVENT_ASYNC_STALL = "async/min_arrivals_stall"

# -- SLO autopilot (telemetry/autopilot.py) ----------------------
# Every controller decision is an event carrying the rule that fired, the
# observed metric value, and the old/new knob values — the audit trail the
# chaos storm e2e and /statusz both read.
#: a rule breached its target and tightened its knob (attrs: rule, knob,
#: observed, old, new)
EVENT_AUTOPILOT_ACTUATION = "autopilot/actuation"
#: a rule's breach cleared for relax_after evaluations and the knob probed
#: back toward the subsystem's declared value (same attrs)
EVENT_AUTOPILOT_RELAX = "autopilot/relax"
#: a breach persisted but the knob was already at its bound — emitted once
#: per saturation episode, never repeated per evaluation
EVENT_AUTOPILOT_SATURATED = "autopilot/saturated"
#: knob-id gauges (the autopilot mirrors every knob it owns into the hub
#: so dashboards can overlay actuations on the metrics that drove them):
AUTOPILOT_KNOB_PREFILL_BUDGET = "serve/prefill_token_budget"
AUTOPILOT_KNOB_SPEC_K_MAX = "serve/spec_k_max"
AUTOPILOT_KNOB_STAGE_TIMEOUT_S = "server/collective_stage_timeout_s"
AUTOPILOT_KNOB_QUANT_LEVEL = "server/collective_quantization_level"
AUTOPILOT_KNOB_MAX_STALENESS = "server/async_max_staleness"
#: one-shot actions (no continuous knob value; the event's old/new carry
#: the action's before/after observation, e.g. free blocks):
AUTOPILOT_ACTION_RECLAIM = "serve/memory_reclaim"
AUTOPILOT_ACTION_RESTART = "fleet/restart_replica"
#: controller KPI counters/gauges:
AUTOPILOT_ACTUATIONS = "server/autopilot_actuations_total"
AUTOPILOT_RELAXES = "server/autopilot_relaxes_total"
AUTOPILOT_SATURATIONS = "server/autopilot_saturations_total"
AUTOPILOT_RULES_BREACHED = "server/autopilot_rules_breached"
#: per-round straggler fraction mirrored into the hub at the collective
#: tick site (the series the straggler_deadline rule takes its p90 over)
COLLECTIVE_STRAGGLER_FRAC = "server/collective_straggler_frac"

# -- structured alert kinds (telemetry/health.py) ---------------
# Health watchers emit these as events (same registry discipline) AND
# record them on the monitor's alert tail rolled up into /statusz.
ALERT_EVENT_PREFIX = "alert/"
#: NaN/Inf in the round's aggregated KPI dict (delta norm, server loss)
ALERT_NONFINITE = "alert/nonfinite"
#: straggler-percentile watcher over the collective cohort
ALERT_STRAGGLERS = "alert/stragglers"
#: a collective round on the degradation ladder / budget exhausted
ALERT_DEGRADED_ROUNDS = "alert/degraded_rounds"
#: serve admission queue pinned at its bound
ALERT_QUEUE_SATURATION = "alert/queue_saturation"
#: checkpoint-plane corruption (corrupt round skipped at resume)
ALERT_STORE_CORRUPT = "alert/store_corrupt"
#: live HBM growing monotonically across a full sample window
ALERT_HBM_GROWTH = "alert/hbm_growth"
#: an adapter cohort lost every member for a round (personalization
#: plane degradation — scoped to that cohort only)
ALERT_ADAPTER_COHORT = "alert/adapter_cohort"
#: a fleet replica went dead on the liveness ladder: the
#: fleet degrades by 1/N and its cohorts re-pin to survivors
ALERT_FLEET_REPLICA_DEAD = "alert/fleet_replica_dead"

#: dynamic metric-name families the registry can't enumerate statically:
#: per-strategy-state norms (``server/{state_key}_norm``,
#: strategy/base.py:norm_telemetry). Patterns are re.fullmatch'd.
DYNAMIC_METRIC_PATTERNS: tuple[str, ...] = (r"server/[A-Za-z0-9_]+_norm",)


# Host-plane round-pipeline KPI names. Recorded into the round
# metrics by the strategy / server so the History tracks where the host
# seconds between device rounds actually go:
#: fetch + dequantize seconds of the streaming aggregation (summed across
#: pool workers — can exceed wall-clock on the pipelined path)
AGG_DECODE_TIME = "server/agg_decode_time"
#: fused fold seconds of the streaming aggregation
AGG_FOLD_TIME = "server/agg_fold_time"
#: duration of the most recently COMPLETED background checkpoint write
#: (round N's metrics carry round N-1's write; 0.0 until one completes)
CKPT_ASYNC_WRITE_S = "server/ckpt_async_write_s"

# Elastic-membership KPI names: recorded every round by ServerApp
# from the LivenessTracker + the drivers' HELLO stats.
#: nodes the liveness state machine currently counts as live
NODES_LIVE = "server/nodes_live"
#: nodes with missed pings, not yet declared dead
NODES_SUSPECT = "server/nodes_suspect"
#: nodes declared dead (out of rotation until they re-register)
NODES_DEAD = "server/nodes_dead"
#: readmissions THIS round (dead/crashed nodes back in rotation)
NODES_READMITTED = "server/nodes_readmitted"
#: cumulative node-reported redial backoff seconds (from HELLO payloads)
RECONNECT_BACKOFF_S = "server/reconnect_backoff_s"


# -- names of this package only --------------------------------------------
#: the federated eval of a round, over every client
EVAL_ROUND_TIME = "server/eval_round_time"
#: the server optimizer on the averaged params, its norms included
SERVER_UPDATE_TIME = "server/server_update_time"
#: the trained params' copy to the host, and their hand-off to the transport
CLIENT_GET_PARAMETERS_TIME = "client/get_parameters_time"
CLIENT_PUT_TIME = "client/put_time"


def registered_metric_names() -> frozenset:
    """Every ``server/*`` / ``client/*`` / ``serve/*`` / ``router/*`` name
    declared as a module constant (the static half of the registry; see
    DYNAMIC_METRIC_PATTERNS)."""
    mod = sys.modules[__name__]
    return frozenset(
        v
        for k, v in vars(mod).items()
        if isinstance(v, str)
        and not k.startswith("_")
        and (v.startswith("server/") or v.startswith("client/")
             or v.startswith("serve/") or v.startswith("router/"))
    )


def is_registered_metric(name: str) -> bool:
    if name in registered_metric_names():
        return True
    return any(re.fullmatch(p, name) for p in DYNAMIC_METRIC_PATTERNS)


@dataclasses.dataclass
class WireStats:
    """Bytes-on-wire accounting for the parameter plane: ``raw`` is what a
    payload costs uncompressed, ``wire`` what moved (equal here: the port
    has no wire codec); ``sent`` counts :meth:`ParamTransport.put`,
    ``recv`` counts :meth:`ParamTransport.get`, so on the server's
    transport ``recv`` is the uplink."""

    sent_raw_bytes: int = 0
    sent_wire_bytes: int = 0
    recv_raw_bytes: int = 0
    recv_wire_bytes: int = 0
    n_sent: int = 0
    n_recv: int = 0

    def record_sent(self, raw: int, wire: int) -> None:
        self.sent_raw_bytes += int(raw)
        self.sent_wire_bytes += int(wire)
        self.n_sent += 1

    def record_recv(self, raw: int, wire: int) -> None:
        self.recv_raw_bytes += int(raw)
        self.recv_wire_bytes += int(wire)
        self.n_recv += 1

    def snapshot(self) -> "WireStats":
        return dataclasses.replace(self)

    def metrics_since(self, prev: "WireStats", prefix: str = "server/") -> dict[str, float]:
        """Round-delta metrics: uplink raw/wire bytes and their ratio,
        downlink (broadcast) wire bytes."""
        up_raw = self.recv_raw_bytes - prev.recv_raw_bytes
        up_wire = self.recv_wire_bytes - prev.recv_wire_bytes
        down_wire = self.sent_wire_bytes - prev.sent_wire_bytes
        out = {
            f"{prefix}wire_uplink_raw_bytes": float(up_raw),
            f"{prefix}wire_uplink_bytes": float(up_wire),
            f"{prefix}wire_broadcast_bytes": float(down_wire),
        }
        if up_wire > 0:
            out[f"{prefix}wire_compression_ratio"] = up_raw / up_wire
        return out


def is_oom(e: BaseException) -> bool:
    """Device-memory exhaustion: ``torch.cuda.OutOfMemoryError``, or an
    error whose message says so."""
    import torch

    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()


def dump_memory_profile(save_dir: str, tag: str = "oom", device=None) -> str | None:
    """Write the CUDA caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``: its segments and their blocks) as a
    pickle to ``{save_dir}/memory_{tag}_{ts}.pickle``, the format PyTorch's
    memory viewer reads: the allocation picture at an OOM, left on disk.
    It records no allocation history (``_record_memory_history`` stays as
    the process set it).

    Best effort, like the JAX package's device memory profile: returns the
    path, or None for a CPU ``device``, in a process that has not
    initialised CUDA, and on any failure; it never masks the OOM."""
    import pickle
    import time

    try:
        import torch

        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_initialized():
            return None
        snap = torch.cuda.memory._snapshot()
        out = pathlib.Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"memory_{tag}_{time.strftime('%Y%m%dT%H%M%SZ', time.gmtime())}.pickle"
        with open(path, "wb") as f:
            pickle.dump(snap, f)
        return str(path)
    except Exception:  # noqa: BLE001 — diagnostics must never mask the OOM
        return None


#: bf16 dense peak by device-name substring (first match wins)
PEAK_FLOPS_BY_DEVICE_NAME: list[tuple[str, float]] = [("h100", 989e12)]


def peak_flops_for_device(name: str) -> float | None:
    name = name.lower()
    return next((p for sub, p in PEAK_FLOPS_BY_DEVICE_NAME if sub in name), None)


def model_flops_per_token(cfg: ModelConfig) -> float:
    """Training FLOPs/token ≈ 6·N_nonemb + 12·L·d·s (attention) + 6·d·V
    (the head), the JAX package's formula."""
    d, L, s, v = cfg.d_model, cfg.n_layers, cfg.max_seq_len, cfg.vocab_size
    hidden = cfg.mlp_hidden_size or cfg.expansion_ratio * d
    mlp_w = (3 if cfg.mlp == "swiglu" else 2) * d * hidden
    n_kv = cfg.n_kv_heads or cfg.n_heads
    attn_w = d * (cfg.n_heads + 2 * n_kv) * cfg.d_head + d * d
    n_block = L * (attn_w + mlp_w)
    return 6.0 * n_block + 12 * L * d * s + 6 * d * v


class SpeedMonitor:
    """EMA tokens/s and, on a device with a known peak, MFU."""

    def __init__(self, cfg: ModelConfig, device_name: str, n_devices: int = 1,
                 alpha: float = 0.9) -> None:
        self.flops_per_token = model_flops_per_token(cfg)
        self.device_name = device_name
        self.peak_flops_per_device = peak_flops_for_device(device_name)
        self.n_devices = n_devices
        self.alpha = alpha
        self._ema = 0.0
        self._t = 0

    def update(self, tokens: int, seconds: float) -> dict[str, float]:
        if seconds <= 0:
            return {}
        tps = tokens / seconds
        self._t += 1
        self._ema = self.alpha * self._ema + (1 - self.alpha) * tps
        out = {"throughput/tokens_per_sec": tps,
               "throughput/tokens_per_sec_ema": self._ema / (1 - self.alpha ** self._t)}
        if self.peak_flops_per_device:
            peak = self.peak_flops_per_device * self.n_devices
            out["throughput/mfu"] = tps * self.flops_per_token / peak
        return out
