"""The quantized wire of pdADMM-G-Q: everything that crosses a link.

Counterpart of ``repro.comm``:

  * :mod:`repro_torch.comm.codecs` — the ``WireCodec`` protocol with fp32,
    grid and affine codecs, exact per-payload byte accounting, the packed
    code layout and error-feedback encoding.
  * :mod:`repro_torch.comm.controller` — the residual-driven bit-width
    controller (hysteresis-bounded switches, global byte budget).
  * :mod:`repro_torch.comm.ledger` — ``CommLedger``, the single source of
    truth for bytes on the wire, and the Fig-5 per-iteration model.
  * :mod:`repro_torch.comm.transport` — the ring's neighbour exchange, the
    padded mixed-width wire and the quantized all-reduce, used by
    ``parallel/stage_parallel.py`` and ``parallel/collectives.py``.
  * :mod:`repro_torch.comm.faults` — deterministic wire fault injection and
    the checksum/seqno integrity sentinels (the fault-tolerance layer behind
    ``distributed_train(faults=/health=/ckpt=)``).
"""
from repro_torch.comm.codecs import (AffineCodec, Fp32Codec, GridCodec,
                                     WireCodec, WirePayload, codec_for_bits,
                                     codec_for_grid,
                                     encode_with_error_feedback,
                                     fake_quantize)
from repro_torch.comm.controller import BitWidthController, ControllerConfig
from repro_torch.comm.faults import (EDGES, SENTINEL_HEADER_BYTES,
                                     FaultControls, FaultPlan, GoodSlabs,
                                     RecoveryConfig, SentinelExchange,
                                     checksum_header, flip_bits,
                                     flip_payload, null_controls,
                                     payload_checksum, verify_header)
from repro_torch.comm.ledger import CommLedger, FaultRecord, WireRecord
from repro_torch.comm.transport import (ContainerExchange, NeighborExchange,
                                        PaddedWire, PsumWireCost, psum_mode,
                                        psum_wire_bytes,
                                        psum_with_error_feedback,
                                        quantized_psum, record_psum)

__all__ = [
    "AffineCodec", "Fp32Codec", "GridCodec", "WireCodec", "WirePayload",
    "codec_for_bits", "codec_for_grid", "encode_with_error_feedback",
    "fake_quantize", "BitWidthController", "ControllerConfig", "CommLedger",
    "FaultRecord", "WireRecord", "EDGES", "SENTINEL_HEADER_BYTES",
    "FaultControls", "FaultPlan", "GoodSlabs", "RecoveryConfig",
    "SentinelExchange", "checksum_header", "flip_bits", "flip_payload",
    "null_controls", "payload_checksum", "verify_header", "ContainerExchange", "NeighborExchange",
    "PaddedWire", "PsumWireCost", "psum_mode", "psum_wire_bytes",
    "psum_with_error_feedback", "quantized_psum", "record_psum",
]
