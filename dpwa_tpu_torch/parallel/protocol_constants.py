"""The constants of the gossip blob protocol, byte for byte the reference's.

The port's own copy of the part of :mod:`dpwa_tpu.parallel.protocol_constants`
that the TCP transport speaks: the request magics, the blob frame's
header, its payload codes, the BUSY shed frame, the STATE wire (its
request, its chunk header and the packed state blob's framing) and the
size clamps.
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

# Response magics (4 bytes, the first field of a header).
BLOB_MAGIC = b"DPWA"
STATE_MAGIC = b"DPWS"
BUSY_MAGIC = b"DPWB"

# Gossip blob header: magic(4s) version(B) dtype(B) clock(d) loss(d) nbytes(Q).
BLOB_HDR = struct.Struct("<4sBBddQ")
# Busy shed reply: magic(4s) version(B) retry_hint_ms(H).  Deliberately
# shorter than the blob header: a fetcher that does not know it reads EOF
# inside the header and classifies a short read.
BUSY_HDR = struct.Struct("<4sBH")
# State request body after STATE_REQ: offset(Q) max_chunk(I).
STATE_REQ_BODY = struct.Struct("<QI")
# State response header: magic(4s) version(B) generation(I) total(Q)
# offset(Q) chunk_len(I) crc32(I).
STATE_HDR = struct.Struct("<4sBIQQII")

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

# Size clamps (DoS bounds, part of the served contract): 16 GiB on an
# advertised payload, 64 MiB on one STATE chunk a server sends.
MAX_BLOB_BYTES = 1 << 34
MAX_STATE_CHUNK_BYTES = 1 << 26
