"""The constants of the gossip blob protocol, byte for byte the reference's.

The port's own copy of the part of :mod:`dpwa_tpu.parallel.protocol_constants`
that the TCP transport speaks: the request magics, the blob frame's
header, its payload codes, the BUSY shed frame, the STATE wire (its
request, its chunk header and the packed state blob's framing), the RELAY
wire (the indirect probe's request and report, and the report's outcome
names), the membership digest trailer, the observability trailer's header
(read past, never decoded) and the size clamps.
A node of either package reads the other's frames, so nothing here may
differ from the reference (``tests/test_torch_tcp.py`` holds every value
against it).  Stdlib only.

A client's first write is a 5-byte request magic; the Rx server reads
exactly 5 bytes and dispatches on them.  Response frames lead with a
4-byte magic inside a fixed, little-endian struct header.
"""

from __future__ import annotations

import struct

# Request magics (5 bytes, the client's first write).
BLOB_REQ = b"DPWA?"  # gossip blob fetch: BLOB_HDR + payload (+ trailers) back
STATE_REQ = b"DPWA@"  # state transfer (crash recovery), then STATE_REQ_BODY
RELAY_REQ = b"DPWA!"  # relay probe (epidemic membership)

# Response and trailer magics (4 bytes, the first field of a header).
BLOB_MAGIC = b"DPWA"
STATE_MAGIC = b"DPWS"
RELAY_MAGIC = b"DPWR"
BUSY_MAGIC = b"DPWB"
DIGEST_MAGIC = b"DPWM"  # the membership digest, a trailer after the payload
OBS_MAGIC = b"DPWT"  # the observability section, a trailer after the digest

# Gossip blob header: magic(4s) version(B) dtype(B) clock(d) loss(d) nbytes(Q).
BLOB_HDR = struct.Struct("<4sBBddQ")
# Busy shed reply: magic(4s) version(B) retry_hint_ms(H), shorter than the
# blob header on purpose (BACK_COMPAT["busy_nack_short_frame"]).
BUSY_HDR_FMT = "<4sBH"
BUSY_HDR = struct.Struct(BUSY_HDR_FMT)
# State request body after STATE_REQ: offset(Q) max_chunk(I).
STATE_REQ_BODY = struct.Struct("<QI")
# State response header: magic(4s) version(B) generation(I) total(Q)
# offset(Q) chunk_len(I) crc32(I).
STATE_HDR = struct.Struct("<4sBIQQII")
# Relay request body after RELAY_REQ: target_index(H) target_port(H)
# probe_timeout_ms(I) hostlen(B), then the target's host bytes.
RELAY_BODY_FMT = "<HHIB"
RELAY_BODY = struct.Struct(RELAY_BODY_FMT)
# Relay report: magic(4s) version(B) outcome(B) clock(d); ``outcome``
# indexes RELAY_OUTCOME_NAMES, a clock below 0 means unknown.
RELAY_HDR_FMT = "<4sBBd"
RELAY_HDR = struct.Struct(RELAY_HDR_FMT)
# Membership digest trailer: magic(4s) version(B) origin(H) round(I)
# entry_count(H), then the entries: v1 peer(H) state(B) incarnation(I)
# suspicion(f); v2 (hierarchical) appends island(H) leader_term(H) flags(B).
DIGEST_HDR_FMT = "<4sBHIH"
DIGEST_ENTRY_FMT = "<HBIf"
DIGEST_ENTRY_V2_FMT = "<HBIfHHB"
DIGEST_HDR = struct.Struct(DIGEST_HDR_FMT)
DIGEST_ENTRY = struct.Struct(DIGEST_ENTRY_FMT)
DIGEST_ENTRY_V2 = struct.Struct(DIGEST_ENTRY_V2_FMT)
# Observability trailer header: magic(4s) version(B) sketch_count(H)
# trace_id(I) loss_ema(f) reserved(H), then sketch_count float32 values.
OBS_HDR = struct.Struct("<4sBHIfH")
OBS_VERSION = 1

# Payload codes: the ``dtype`` byte of BLOB_HDR.  Codes 0-3 are flat
# little-endian vectors; 4-6 are the reference's codecs (int8-chunked,
# top-k delta, sharded), whose bodies the port does not decode yet.
PAYLOAD_F32 = 0
PAYLOAD_F64 = 1
PAYLOAD_U16 = 2
PAYLOAD_BF16 = 3
PAYLOAD_INT8_CHUNKED = 4
PAYLOAD_TOPK_DELTA = 5
PAYLOAD_SHARD = 6
CODEC_PAYLOAD_CODES = (PAYLOAD_INT8_CHUNKED, PAYLOAD_TOPK_DELTA, PAYLOAD_SHARD)

# Length prefix of the packed state blob's JSON header
# (recovery/state_transfer.py), and the blob's own magic: the blob rides
# opaquely inside DPWS chunks, but a donor and a rejoiner of either package
# must agree on its framing.
STATE_PACK_LEN = struct.Struct("<I")
STATE_PACK_MAGIC = b"DPST"

# The relay report's outcome byte, by index: the names of the classified
# probe outcomes (the port's Outcome strings, asserted in parallel/tcp.py).
RELAY_OUTCOME_NAMES = ("success", "timeout", "refused", "short_read", "corrupt", "busy")

# Size clamps (DoS bounds, part of the served contract): 16 GiB on an
# advertised payload, 64 MiB on one STATE chunk a server sends, 1 MiB on a
# digest trailer, 4096 values in an observability trailer, and 500 ms on
# the probe a relay runs for a requester.
MAX_BLOB_BYTES = 1 << 34
MAX_STATE_CHUNK_BYTES = 1 << 26
MAX_DIGEST_BYTES = 1 << 20
MAX_SKETCH_VALUES = 4096
MAX_RELAY_TIMEOUT_MS = 500

# Why a layout above is as it is: part of the served contract.
BACK_COMPAT = {
    "busy_nack_short_frame": (
        "The DPWB frame is 7 bytes, shorter than the 30-byte blob header: a "
        "fetcher that does not know it hits EOF inside its header read when "
        "the server closes and classifies a short read, while a "
        "flowctl-aware fetcher peeks the 4-byte magic, reads the other 3 "
        "and records the low-weight busy outcome, which soft-degrades the "
        "peer instead of quarantining it."
    ),
}
