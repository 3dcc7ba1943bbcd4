"""The quantized wire of pdADMM-G-Q: codecs and byte accounting.

Counterpart of ``repro.comm`` for what single-host training needs:

  * :mod:`repro_torch.comm.codecs` — the ``WireCodec`` protocol with fp32,
    grid and affine codecs, exact per-payload byte accounting, the packed
    code layout and error-feedback encoding.
  * :mod:`repro_torch.comm.ledger` — ``CommLedger``, the single source of
    truth for bytes on the wire, and the Fig-5 per-iteration model.

The bit-width controller, fault injection and the transport come with the
port's distributed runtime.
"""
from repro_torch.comm.codecs import (AffineCodec, Fp32Codec, GridCodec,
                                     WireCodec, WirePayload, codec_for_bits,
                                     codec_for_grid,
                                     encode_with_error_feedback,
                                     fake_quantize)
from repro_torch.comm.ledger import CommLedger, FaultRecord, WireRecord

__all__ = [
    "AffineCodec", "Fp32Codec", "GridCodec", "WireCodec", "WirePayload",
    "codec_for_bits", "codec_for_grid", "encode_with_error_feedback",
    "fake_quantize", "CommLedger", "FaultRecord", "WireRecord",
]
