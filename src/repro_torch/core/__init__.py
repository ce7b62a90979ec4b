"""Core: the label-routed, capacity-bounded, deterministic-latency
sparse-event interconnect (port of ``repro.core``; the names the port has,
in the reference's grouping)."""

from repro_torch.core.events import (  # noqa: F401
    EventFrame, PackedWords, empty_frame, make_frame, make_frame_argsort,
    make_frame_segmented, concatenate_frames, pack_words, unpack_words,
    pack_wire16, unpack_wire16, words_required,
    CapacityPolicy, SPIKES_PER_WORD, WIRE_VALID_BIT,
)
from repro_torch.core.routing import (  # noqa: F401
    RoutingTables, build_fwd_table, build_rev_table, identity_tables,
    lookup_fwd, lookup_rev, route_outbound, route_inbound,
    full_route_enables, feedforward_route_enables, fan_in_route_enables,
    aggregate, aggregate_baseline,
)
from repro_torch.core.fabric import (  # noqa: F401
    LevelSpec, FabricSpec, LevelPlan, FabricPlan, compile_fabric,
    fabric_route_step, fabric_exchange, FabricInterconnect,
    EXCHANGE_MODES, with_exchange_mode, pick_exchange_mode,
    star_spec, hierarchical_spec, ext_4case_spec,
    FabricHealth, FaultEvent, full_health, degrade_spec, health_schedule,
    dead_edges_at, fault_boundaries,
)
from repro_torch.core.aggregator import (  # noqa: F401
    RouterState, ExchangeDrops, identity_router, route_step,
    route_step_baseline, route_step_hierarchical, star_exchange,
    hierarchical_exchange, StarInterconnect,
)
from repro_torch.core.sync import (  # noqa: F401
    SyncConfig, barrier, barrier_release_time, refractory_mask,
)
from repro_torch.core.latency import (  # noqa: F401
    LatencyParams, DEFAULT_PARAMS, simulate_fan_in, latency_statistics,
    biological_latency_ms, queue_wait_ns, queue_wait_i32, hop_delays,
    HopDelays, TimedWire, timed_wire, PAPER_BAND_NS, PAPER_JITTER_FRAC,
)
from repro_torch.core.link import (  # noqa: F401
    Encoding, LinkConfig, ENC_8B10B, ENC_64B66B,
    LINK_LATENCY_OPTIMIZED, LINK_BANDWIDTH_OPTIMIZED,
)
from repro_torch.core.interconnect import (  # noqa: F401
    Topology, PROTOTYPE_4CHIP, FULL_BACKPLANE, FULL_RACK, PROJECTED_120CHIP,
)
