"""Host-side FL machinery of the port: wire plane, packets, simulator,
transports, fleets, topologies and the sync and async orchestrators.

Transports are pluggable: every protocol implements the ``Transport``
interface (:mod:`repro_torch.core.transport`) and registers under a string
key, and the orchestrator dispatches purely through the registry.
Built-ins: ``mudp`` (the paper's protocol), the ``udp`` / ``tcp``
baselines, and ``mudp+fec`` (MUDP + XOR parity), which registers when this
package imports :mod:`repro_torch.core.fec`.

The event calendar, transports, keyed RNG and wire bytes are numpy and
Python, as in the reference; arrays cross to the device only in client
training (:mod:`repro_torch.models`), the ``int8`` and ``topk`` wire
stages (:mod:`repro_torch.core.wire`) and aggregation
(:mod:`repro_torch.core.aggregation`).
"""

from repro_torch.core.aggregation import (fedavg, fedavg_stack,
                                          pairwise_average, trimmed_mean)
from repro_torch.core.client_compute import (BatchTrainer, ClientModel,
                                             ConsensusModel, TrainBackend,
                                             attach_trainer, available_models,
                                             available_train_backends,
                                             make_model, make_train_backend,
                                             register_model,
                                             register_train_backend)
from repro_torch.core.channel import (DCN_LINK, PAPER_LINK, WAN_LINK,
                                      BernoulliLoss, DropList, GilbertElliott,
                                      Link, LossModel, NoLoss, keyed_uniform,
                                      keyed_uniforms, packet_key_arrays)
from repro_torch.core.compression import (Codec, HexCodec, Int8Codec, RawCodec,
                                          TopKCodec, make_codec)
from repro_torch.core.control import (AdaptivePolicy, ControlDecision,
                                      ControlPolicy, StaticPolicy,
                                      available_policies, make_policy,
                                      register_policy)
from repro_torch.core.fec import (FecMudpReceiver, FecMudpSender,
                                  FecMudpTransport, parity_groups)
from repro_torch.core.fleet import (COHORT_PRESETS, ClientProfile, CohortSpec,
                                    ConsensusObjective, FleetBuild,
                                    FleetConfig, build_fleet,
                                    build_fleet_training, cohort_counts,
                                    links_for, profiles_digest,
                                    sample_profiles)
from repro_torch.core.mudp import (MudpReceiver, MudpSender, TxnStats)
from repro_torch.core.packetizer import (Packetizer, flatten_to_vector,
                                         packetize, reassemble,
                                         unflatten_from_vector)
from repro_torch.core.packets import (Packet, PacketKind, make_ack_ok,
                                      make_data_packet, make_nack)
from repro_torch.core.rounds import (FederatedSystem, FLClient, FLConfig,
                                     RoundResult)
from repro_torch.core.scheduling import (SCHEDULERS, AsyncScheduler,
                                         SyncScheduler, make_scheduler)
from repro_torch.core.server import (ClientPool, ClientSession, ServerCore)
from repro_torch.core.simulator import (Node, Simulator)
from repro_torch.core.tcp import (TcpReceiver, TcpSender)
from repro_torch.core.telemetry import (ClientHealth, Telemetry)
from repro_torch.core.topology import (CellScheduler, EdgeAggregator,
                                       GossipSystem, GossipTopology,
                                       HierSystem, HierTopology, StarTopology,
                                       Topology, available_topologies,
                                       make_topology, neighbor_graph,
                                       register_topology, topology_hops)
from repro_torch.core.transport import (Delivery, Transport, TransportCaps,
                                        TransportConfig, available_transports,
                                        make_transport, register_transport,
                                        validate_transport_kind)
from repro_torch.core.udp import (UdpReceiver, UdpSender, reassemble_partial)
from repro_torch.core.wire import (CodecStage, CrcStage, DeltaStage,
                                   ErrorFeedbackStage, HexStage, Int8Stage,
                                   Pipeline, PipelineCaps, PipelineState,
                                   RawStage, Stage, TopKStage, WireDecodeError,
                                   WireError, WireHeader, available_stages,
                                   chunksum32, decode_payload, legacy_pipeline,
                                   migrate_state, parse_hop_specs,
                                   parse_pipeline, parse_stage, register_stage,
                                   stage_for_codec)

__all__ = [
    "fedavg", "fedavg_stack", "pairwise_average", "trimmed_mean",
    "BatchTrainer", "ClientModel", "ConsensusModel", "TrainBackend",
    "attach_trainer", "available_models", "available_train_backends",
    "make_model", "make_train_backend", "register_model",
    "register_train_backend",
    "DCN_LINK", "PAPER_LINK", "WAN_LINK",
    "BernoulliLoss", "DropList", "GilbertElliott", "Link", "LossModel",
    "NoLoss", "keyed_uniform", "keyed_uniforms", "packet_key_arrays",
    "Codec", "HexCodec", "Int8Codec", "RawCodec", "TopKCodec", "make_codec",
    "AdaptivePolicy", "ControlDecision", "ControlPolicy", "StaticPolicy",
    "available_policies", "make_policy", "register_policy",
    "FecMudpReceiver", "FecMudpSender", "FecMudpTransport", "parity_groups",
    "COHORT_PRESETS", "ClientProfile", "CohortSpec", "ConsensusObjective",
    "FleetBuild", "FleetConfig", "build_fleet", "build_fleet_training",
    "cohort_counts", "links_for", "profiles_digest", "sample_profiles",
    "MudpReceiver", "MudpSender", "TxnStats",
    "Packetizer", "flatten_to_vector", "packetize", "reassemble",
    "unflatten_from_vector",
    "Packet", "PacketKind", "make_ack_ok", "make_data_packet", "make_nack",
    "FederatedSystem", "FLClient", "FLConfig", "RoundResult",
    "SCHEDULERS", "AsyncScheduler", "SyncScheduler", "make_scheduler",
    "ClientPool", "ClientSession", "ServerCore",
    "Node", "Simulator",
    "TcpReceiver", "TcpSender",
    "ClientHealth", "Telemetry",
    "CellScheduler", "EdgeAggregator", "GossipSystem", "GossipTopology",
    "HierSystem", "HierTopology", "StarTopology", "Topology",
    "available_topologies", "make_topology", "neighbor_graph",
    "register_topology", "topology_hops",
    "Delivery", "Transport", "TransportCaps", "TransportConfig",
    "available_transports", "make_transport", "register_transport",
    "validate_transport_kind",
    "UdpReceiver", "UdpSender", "reassemble_partial",
    "CodecStage", "CrcStage", "DeltaStage", "ErrorFeedbackStage", "HexStage",
    "Int8Stage", "Pipeline", "PipelineCaps", "PipelineState", "RawStage",
    "Stage", "TopKStage", "WireDecodeError", "WireError", "WireHeader",
    "available_stages", "chunksum32", "decode_payload", "legacy_pipeline",
    "migrate_state", "parse_hop_specs", "parse_pipeline", "parse_stage",
    "register_stage", "stage_for_codec",
]
