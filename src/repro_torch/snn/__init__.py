"""The chip substrate: neurons, chips, multi-chip networks, encoders,
plasticity and training (port of ``repro.snn``, its names in its
grouping)."""

from repro_torch.snn.neuron import (  # noqa: F401
    NeuronParams, NeuronState, LIF, ADEX, init_state as init_neuron_state,
    neuron_step, spike_fn,
)
from repro_torch.snn.chip import (  # noqa: F401
    ChipConfig, ChipParams, ChipState, init_params as init_chip_params,
    init_state as init_chip_state, chip_step, quantize_ste,
    spikes_to_labels, labels_to_rows, N_NEURONS, N_SYNAPSE_ROWS,
)
from repro_torch.snn.network import (  # noqa: F401
    NetworkConfig, NetworkParams, NetworkState, init_feedforward,
    init_state as init_network_state, init_stream_plasticity,
    routing_matrices, step_dense, step_event, run_dense, run_event,
    run_event_steps,
)
from repro_torch.snn.stream import (  # noqa: F401
    StreamOut, run_stream, stream_latency_stats,
)
from repro_torch.snn.encoding import (  # noqa: F401
    poisson_encode, latency_encode, regular_encode,
)
from repro_torch.snn.plasticity import (  # noqa: F401
    STDPConfig, STDPState, StreamPlasticityState, init_stdp,
    init_stream_stdp, stdp_step, stdp_stream_step,
)
