"""serve/: the fleet's front door (counterpart of ``metrics_tpu/serve``).

Everything below the waterline — bucketed dispatch (``engine/stream.py``),
session sharding (``engine/sharded.py``), WAL durability
(``engine/durability.py``), per-session metering with a demotion handshake
(``observe/metering.py``) and the SLO watchdog (``observe/watchdog.py``) —
already exists; this package is how remote producers reach it and how the
fleet's own signals become reflexes:

* :mod:`metrics_tpu_torch.serve.protocol` — the MTWAL001 CRC-framed record format
  lifted onto the wire: a producer's socket stream *is* the journal format,
  with per-producer sequence watermarks for exactly-once application over
  at-least-once delivery and a credit-based backpressure window.
* :mod:`metrics_tpu_torch.serve.server` — stdlib ``selectors`` socket server:
  authenticates a session key, routes by the stable crc32 shard hash,
  journals every applied record (write-ahead) before acking, and coalesces
  remote submissions into the normal per-bucket waves via ``submit()``.
* :mod:`metrics_tpu_torch.serve.admission` — the explicit admission-control table:
  accept / defer-with-retry-after / shed-loose-first / reject, driven by live
  occupancy, quota, watchdog and WAL-lag signals.
* :mod:`metrics_tpu_torch.serve.autonomic` — the observe→act controller: occupancy
  pressure → pre-emptive capacity doubling; sustained quota breaches → the
  existing demotion handshake; shard imbalance → rendezvous-free elastic
  resize; overload → shed loose sessions first. Every action rate-limited,
  logged as structured observe events, and dry-runnable.
"""

from metrics_tpu_torch.serve.admission import (
    ADMISSION_VERDICTS,
    AdmissionController,
    AdmissionDecision,
    AdmissionRule,
    DEFAULT_ADMISSION_TABLE,
)
from metrics_tpu_torch.serve.autonomic import (
    AUTONOMIC_ACTIONS,
    AutonomicAction,
    AutonomicController,
    shed_loose,
)
from metrics_tpu_torch.serve.protocol import (
    DATA_KINDS,
    DEFAULT_MAX_FRAME_BYTES,
    DEFAULT_WINDOW,
    PROTO_VERSION,
    FrameDecoder,
    Producer,
    ProtocolError,
    decode_blob,
    encode_frame,
)
from metrics_tpu_torch.serve.server import MetricsServer

__all__ = [
    "ADMISSION_VERDICTS",
    "AUTONOMIC_ACTIONS",
    "AdmissionController",
    "AdmissionDecision",
    "AdmissionRule",
    "AutonomicAction",
    "AutonomicController",
    "DATA_KINDS",
    "DEFAULT_ADMISSION_TABLE",
    "DEFAULT_MAX_FRAME_BYTES",
    "DEFAULT_WINDOW",
    "FrameDecoder",
    "MetricsServer",
    "PROTO_VERSION",
    "Producer",
    "ProtocolError",
    "decode_blob",
    "encode_frame",
    "shed_loose",
]
