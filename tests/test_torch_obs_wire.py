"""The observability plane's wire pieces against the reference: the ``DPWT``
trailer's bytes, the sketch's signs and values, and the sketch board.

The sketch's signs are bit-equal to ``jax.random.rademacher``'s.  Its values
are float32 block sums in another order than numpy's, so they are held to
the float32 summation bound ``2·m·2⁻²⁴·Σ|v_i|`` of each block of ``m``
(both sums' worst-case error), and bit for bit on replicas of small integers,
whose every partial sum is exact.
"""

import math

import numpy as np
import pytest
import torch

from dpwa_tpu.obs import sketch as ref_sketch
from dpwa_tpu.obs import wire as ref_wire
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.obs import sketch, wire
from dpwa_tpu_torch.parallel import schedules, tcp
from dpwa_tpu_torch.utils import prng

ENCODE_CASES = {
    "sketch": (3, 41, 2.5, np.linspace(-1, 1, 64, dtype=np.float32)),
    "trace_only": (1, 7, 0.0, None),
    "wrapping": (70000 + 3, (1 << 32) + 5, -1.25, np.arange(3, dtype=np.float32)),
    "one_value": (0, 0, 1.0, np.array([0.5], np.float32)),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_obs_bytes_equal_reference(case):
    origin, seq, norm, sk = ENCODE_CASES[case]
    blob = wire.encode_obs(origin, seq, norm, sk)
    assert blob == ref_wire.encode_obs(origin, seq, norm, sk)
    mine, theirs = wire.decode_obs(blob), ref_wire.decode_obs(blob)
    assert (mine.origin, mine.seq, mine.norm_est, mine.trace_id) == (
        theirs.origin, theirs.seq, theirs.norm_est, theirs.trace_id)
    if sk is None:
        assert mine.sketch is None and theirs.sketch is None
    else:
        assert np.array_equal(mine.sketch, theirs.sketch)
        assert mine.sketch.dtype == np.float32


def test_decode_obs_malformed_like_reference():
    """Truncations, a wrong magic or version, an absurd count, a count the
    body does not match, non-finite values: None from both; and a sketch
    over the cap is refused by both encoders."""
    good = ref_wire.encode_obs(2, 9, 1.0, np.arange(4, dtype=np.float32))
    bad_version = good[:4] + bytes([2]) + good[5:]
    absurd = bytearray(good)
    absurd[15:17] = (5000).to_bytes(2, "little")
    nan = ref_wire.encode_obs(2, 9, 1.0, np.array([1.0, np.nan], np.float32))
    inf = ref_wire.encode_obs(2, 9, 1.0, np.array([np.inf], np.float32))
    blobs = [b"", good[:5], good[:-1], good + b"\0", b"DPWX" + good[4:], bad_version,
             bytes(absurd), nan, inf, good]
    for blob in blobs:
        mine, theirs = wire.decode_obs(blob), ref_wire.decode_obs(blob)
        assert (mine is None) == (theirs is None), blob
        if mine is not None:
            assert mine.trace_id == theirs.trace_id
            assert np.array_equal(mine.sketch, theirs.sketch)
    assert wire.decode_obs(good) is not None
    too_long = np.zeros(wire.MAX_SKETCH_VALUES + 1, np.float32)
    with pytest.raises(ValueError):
        wire.encode_obs(0, 0, 0.0, too_long)
    with pytest.raises(ValueError):
        ref_wire.encode_obs(0, 0, 0.0, too_long)
    for head in (good[:wire.OBS_HEADER_SIZE], bad_version[:wire.OBS_HEADER_SIZE],
                 bytes(absurd)[:wire.OBS_HEADER_SIZE], good[:5]):
        assert wire.header_sketch_count(head) == ref_wire.header_sketch_count(head)
    assert wire.values_size(7) == ref_wire.values_size(7) == 28


@pytest.mark.parametrize("trailers", ["digest_obs", "obs_only", "digest_only"])
def test_fetch_reads_the_obs_trailer_as_the_reference(trailers):
    """A reference server's frame with a digest and a DPWT section, the
    section alone, or the digest alone: the port's fetch hands back the
    digest and the section the reference's fetch reads."""
    from dpwa_tpu.membership import digest as ref_digest

    dig = ref_digest.encode_digest(ref_digest.Digest(2, 5, {
        0: ref_digest.MemberEntry(state=1, incarnation=2, suspicion=1.25)}))
    obs = ref_wire.encode_obs(2, 7, 1.5, np.arange(16, dtype=np.float32))
    kw = {"digest_obs": {"digest": dig, "obs": obs}, "obs_only": {"obs": obs},
          "digest_only": {"digest": dig}}[trailers]
    vec = np.linspace(-1, 1, 300).astype(np.float32)
    srv = ref_tcp.PeerServer("127.0.0.1", 0)
    try:
        srv.publish(vec, 3.0, 0.5, **kw)
        box, obs_box = [], []
        got, outcome, _l, _n = tcp.fetch_blob_full("127.0.0.1", srv.port, 2000,
                                                   trailer_box=box, obs_box=obs_box)
        want = ref_tcp.fetch_blob_full("127.0.0.1", srv.port, 2000, want_digest=True,
                                       want_obs=True)
        assert outcome == want[1] == "success"
        assert np.array_equal(got[0].numpy(), vec)
        assert box == [want[4]] and obs_box == [want[5]]
        assert obs_box == [kw.get("obs")]
    finally:
        srv.close()


@pytest.mark.parametrize("seed,n,k", [(0, 1000, 64), (7, 777, 16), (3, 5, 4)])
def test_sketch_signs_bit_equal_to_reference(seed, n, k):
    """n a multiple of k, not one, and shorter than 2k (a block of padding
    only)."""
    mine = sketch.sketch_signs(seed, n, k).numpy()
    want = ref_sketch._sketch_signs(seed, n, k)
    assert mine.shape == want.shape == (k, -(-n // k)) and mine.dtype == np.int8
    assert np.array_equal(mine.astype(np.float32), want)


def test_rademacher_is_the_uniform_below_half():
    """The raw-bits derivation equals ``2·(uniform < 0.5) − 1`` on the
    port's bit-equal uniform, the reference's definition."""
    key = schedules._pair_key(11, 0, 0, sketch.SKETCH_TAG)
    signs = prng.rademacher(key, (5000,))
    want = 2.0 * (prng.uniform(key, (5000,)) < 0.5).to(torch.float32) - 1.0
    assert torch.equal(signs, want)
    assert torch.equal(prng.rademacher(key, (5000,), dtype=torch.int8), want.to(torch.int8))


def _block_bound(v: np.ndarray, k: int) -> np.ndarray:
    """Each block's float32 summation bound, ``2·m·2⁻²⁴·Σ|v_i|``."""
    m = -(-v.size // k)
    padded = np.zeros(k * m, np.float64)
    padded[:v.size] = np.abs(v)
    return 2 * m * 2.0 ** -24 * padded.reshape(k, m).sum(1)


@pytest.mark.parametrize("n,k", [(4099, 64), (100000, 32)])
def test_replica_sketch_within_summation_bound_of_reference(n, k):
    v = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    mine = sketch.replica_sketch(torch.from_numpy(v), 5, k)
    want = ref_sketch.replica_sketch(v, 5, k)
    assert mine.dtype == np.float32 and mine.shape == (k,)
    assert np.all(np.abs(mine.astype(np.float64) - want) <= _block_bound(v, k))
    # A host array goes through the same path.
    assert np.array_equal(sketch.replica_sketch(v, 5, k), mine)


def test_replica_sketch_bit_equal_on_small_integers():
    for n, k in ((4099, 64), (640, 64), (10, 4), (5, 4)):
        v = np.random.default_rng(n).integers(-8, 9, n).astype(np.float32)
        assert np.array_equal(sketch.replica_sketch(torch.from_numpy(v), 2, k),
                              ref_sketch.replica_sketch(v, 2, k))
    assert np.array_equal(sketch.replica_sketch(torch.zeros(0), 2, 8), np.zeros(8, np.float32))


def test_sketchboard_equal_reference():
    """The same notes (a stale seq, a reset, a shape mismatch, self notes)
    give the reference's ``disagreement`` and ``snapshot``."""
    rng = np.random.default_rng(3)
    sk = lambda: rng.standard_normal(8).astype(np.float32)  # noqa: E731
    mine, theirs = sketch.SketchBoard(1, 8), ref_sketch.SketchBoard(1, 8)
    for board in (mine, theirs):
        assert board.disagreement() == (None, None)
    notes = [("remote", 0, 5, sk()), ("local", None, 5, sk()), ("remote", 2, 6, sk()),
             ("remote", 0, 3, sk()), ("remote", 0, 2000000, sk()), ("remote", 0, 1, sk()),
             ("remote", 1, 9, sk()), ("remote", 3, 1, np.ones(4, np.float32)),
             ("local", None, 6, sk())]
    for kind, origin, seq, s in notes:
        for board in (mine, theirs):
            if kind == "local":
                board.note_local(seq, s)
            else:
                board.note_remote(origin, seq, s, round=seq)
        assert mine.disagreement() == theirs.disagreement()
        assert mine.snapshot() == theirs.snapshot()
    assert mine.snapshot()["peers_seen"] == 3
    rms, rel = mine.disagreement()
    assert math.isfinite(rms) and math.isfinite(rel)
