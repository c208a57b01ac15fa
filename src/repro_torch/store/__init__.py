"""The storage layer of a DisCEdge deployment — the port's copy of
``repro.store``: the versioned replica, the discrete-event network with
fault injection, the FReD-like keygroup store with its outbox and
anti-entropy, and KV-page shipping."""

from .kvstore import Replica, VersionedValue
from .network import (
    MESSAGE_OVERHEAD_BYTES,
    DegradedWindow,
    DropWindow,
    FaultPlan,
    Link,
    Network,
    NodeDownWindow,
    PartitionWindow,
    SimClock,
    TrafficCounter,
)
from .distributed import (
    ACK_TAG,
    DistributedKVStore,
    Keygroup,
    OutboxItem,
    OutboxPolicy,
    SYNC_TAG,
)
from .kv_ship import (
    KV_SHIP_ACK_TAG,
    KV_SHIP_CTRL_TAG,
    KV_SHIP_DATA_TAG,
    KVShipper,
    NodeShipProfile,
    PageShipment,
    ShipEstimate,
    page_digests,
)

__all__ = [
    "Replica",
    "VersionedValue",
    "MESSAGE_OVERHEAD_BYTES",
    "DegradedWindow",
    "DropWindow",
    "FaultPlan",
    "Link",
    "Network",
    "NodeDownWindow",
    "PartitionWindow",
    "SimClock",
    "TrafficCounter",
    "ACK_TAG",
    "DistributedKVStore",
    "Keygroup",
    "OutboxItem",
    "OutboxPolicy",
    "SYNC_TAG",
    "KV_SHIP_ACK_TAG",
    "KV_SHIP_CTRL_TAG",
    "KV_SHIP_DATA_TAG",
    "KVShipper",
    "NodeShipProfile",
    "PageShipment",
    "ShipEstimate",
    "page_digests",
]
