"""Protocol mode constants + the `ProtocolConfig` knob record.

Every preset in the zoo (`repro_torch.core.protocols.presets`) is an instance of
`ProtocolConfig`; the engine never branches on the preset name — it reads the
knobs below, traced as `DynProto` scalars, so one compiled program serves
every protocol (see docs/architecture.md "Protocol zoo").
"""

from __future__ import annotations

import dataclasses

# stagger modes
STAGGER_NONE = 0
STAGGER_NET = 1  # Eq.(3)
STAGGER_NET_LEL = 2  # Eq.(8)

# prepare modes
PREPARE_COORD = 0  # DM-coordinated WAN prepare round (2PC)
PREPARE_DECENTRAL = 1  # geo-agent triggers prepare after last statement (O1)
PREPARE_NONE = 2  # no prepare (no atomicity: SSP-local)


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    name: str = "geotp"
    prepare: int = PREPARE_DECENTRAL
    stagger: int = STAGGER_NET_LEL
    admission: bool = True  # O3 late transaction scheduling (Eq.9)
    early_abort: bool = True  # geo-agent peer-to-peer abort (O1)
    chiller_two_stage: bool = False  # intra-region first, then cross-region
    middleware_cc: bool = False  # ScalarDB-style: locks at DM, per-op WAN RTT
    async_local_commit: bool = False  # YUGA: single-shard txns apply async
    # FASTC (Fast Commitment, arxiv 2312.01229): the geo-agent next to the
    # data acts as co-coordinator — after the final round it logs locally and
    # commits without reporting back for a DM-driven commit-log round.
    co_commit: bool = False
    # OPTA (optimistic aborts, arxiv 1610.07459): a statement that fails its
    # lock acquisition aborts immediately instead of parking in the lock-wait
    # queue for `lock_timeout_us` (the retry knobs below provide liveness).
    opt_abort: bool = False
    # TIGA (arxiv 2509.05759): statements carry a synchronized-clock deadline
    # `dispatch + tiga_slack_us`; a single-round transaction whose statements
    # all arrive "in the future" (arrival + clock skew <= deadline) executes
    # at the deadline and commits locally in one WAN round. 0 disables.
    tiga_slack_us: int = 0
    lel_scale_milli: int = 1000  # §IV-C forecast scale-down knob
    max_blocked: int = 5  # blocks before O3 aborts the txn
    admission_backoff_us: int = 20_000  # long enough for a_cnt to drain
    block_prob_cap: float = 1.0  # Eq.(9) unclipped; max_blocked bounds blocking
    # engine timing knobs (shared by every preset; per paper defaults)
    lock_timeout_us: int = 5_000_000  # 5 s lock-wait timeout (§VII-A-3)
    exec_us: int = 100  # local execution time per op
    log_flush_us: int = 1000  # WAL/commit-log fsync
    lan_rtt_us: int = 200  # geo-agent <-> data source round trip
    retry_backoff_us: int = 5000
    # benchbase semantics: an aborted transaction is recorded and the terminal
    # moves on to the next one (retries only when explicitly configured)
    max_retries: int = 0
    # heartbeat probe period while a data source is unreachable (fault
    # injection; probes are deterministic reachability checks — see
    # docs/architecture.md)
    hb_interval_us: int = 500_000
    # failure-detection delay: a crash/partition only takes effect (and the
    # cascade/deferral fires) this long after the scheduled fault start, so
    # the fault event no longer doubles as the detection point
    detect_delay_us: int = 0
