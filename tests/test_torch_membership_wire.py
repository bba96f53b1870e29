"""The port's membership plane on the wire against the reference's, on the
CPU: the digest trailer and RELAY.

Each test names the test of ``tests/test_membership.py`` it mirrors.

- The wire: a port node's served frame, trailer included, byte-identical
  to a reference node's after identical histories; each package's fetcher
  reads the other's digest; an old-wire peer (no trailer) and an
  observability section after the digest still succeed
  (``test_frame_without_digest_still_parses``,
  ``test_frame_with_digest_is_backward_compatible``).
- RELAY: a port relay and a reference relay answer the same report bytes
  for a live and for a closed target, and each client reads both
  (``test_relay_probe_vouches_for_live_target``,
  ``test_relay_probe_reports_dead_target``).

Every socket binds port 0 and peers are wired with ``set_peer_port``.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.membership import digest as ref_digest
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.health import Outcome
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import tcp

FLOWCTL_OFF = {"flowctl": {"enabled": False}}


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def _ephemeral(cfg):
    return dataclasses.replace(
        cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes)
    )


def _closed_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _raw_reply(port, request):
    """Every byte a server sends back for ``request``, to its close."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sk:
        sk.sendall(request)
        out = b""
        while True:
            chunk = sk.recv(1 << 16)
            if not chunk:
                return out
            out += chunk


_OUTCOMES = ("success", "success", "success", "refused", "timeout", "short_read", "corrupt",
             "untrusted", "busy")


def _claims(rng, n, me):
    """A random digest blob claimed by a random peer."""
    origin = int(rng.integers(0, n))
    entries = {}
    for p in rng.choice(n, size=int(rng.integers(1, n + 1)), replace=False):
        entries[int(p)] = ref_digest.MemberEntry(
            state=int(rng.integers(0, 4)), incarnation=int(rng.integers(0, 3)),
            suspicion=float(np.float32(rng.random() * 3)))
    return ref_digest.encode_digest(ref_digest.Digest(origin, int(rng.integers(0, 50)), entries))


# -- the wire ----------------------------------------------------------------

def _history_pair(n=4, me=1):
    """A port and a reference transport (membership on, the same config)
    after the same scoreboard and digest history."""
    cfg = dict(schedule="ring", seed=3, **FLOWCTL_OFF)
    ref = ref_tcp.TcpTransport(_ephemeral(ref_config(n, base_port=0, **cfg)), f"node{me}")
    mine = tcp.TcpTransport(_ephemeral(make_local_config(n, schedule="ring", seed=3,
                                                         disabled_planes=("flowctl",))),
                            f"node{me}", device="cpu")
    rng = np.random.default_rng(7)
    for r in range(12):
        peer = int(rng.choice([p for p in range(n) if p != me]))
        out = _OUTCOMES[int(rng.integers(0, 7))]
        blob = _claims(rng, n, me)
        for t in (mine, ref):
            t.scoreboard.record(peer, out, round=r)
            t.membership.merge(blob, round=r)
            t.membership.end_round(r)
    return mine, ref


def test_served_frame_with_trailer_byte_identical_to_reference():
    """Mirrors ``test_frame_with_digest_is_backward_compatible``: the bytes
    a port node serves (header, payload, digest) equal a reference node's
    after identical histories, on both wires."""
    mine, ref = _history_pair()
    try:
        vec = np.random.default_rng(1).standard_normal(777).astype(np.float32)
        mine.publish(torch.from_numpy(vec), 13.0, 0.25)
        ref.publish(vec, 13.0, 0.25)
        got, want = _raw_reply(mine.port, pc.BLOB_REQ), _raw_reply(ref.port, pc.BLOB_REQ)
        assert got == want
        hdr = pc.BLOB_HDR.unpack_from(got, 0)
        trailer = got[pc.BLOB_HDR.size + hdr[5]:]
        assert trailer == mine.membership.encode(13) and len(trailer) == 13 + 4 * 11
        assert mine.last_digest_nbytes == len(trailer)
    finally:
        mine.close()
        ref.close()


def test_each_fetcher_reads_the_other_packages_digest():
    """Mirrors ``test_frame_with_digest_is_backward_compatible``: the
    reference's fetcher reads the port server's digest and the port's
    fetcher the reference server's; the vector and ``nbytes`` are the
    frame's alone."""
    mine, ref = _history_pair()
    try:
        vec = np.arange(100, dtype=np.float32)
        mine.publish(torch.from_numpy(vec), 4.0, 0.5)
        ref.publish(vec, 4.0, 0.5)
        got, outcome, _l, nbytes, dig, _obs = ref_tcp.fetch_blob_full(
            "127.0.0.1", mine.port, 2000, want_digest=True)
        assert outcome == "success" and nbytes == 400 and dig == mine.membership.encode(4)
        box = []
        got, outcome, _l, nbytes = tcp.fetch_blob_full("127.0.0.1", ref.port, 2000,
                                                       trailer_box=box)
        assert outcome == Outcome.SUCCESS and nbytes == 400 and box == [ref.membership.encode(4)]
        assert np.array_equal(got[0].numpy(), vec)
    finally:
        mine.close()
        ref.close()


@pytest.mark.parametrize("trailers", ["none", "digest_obs", "obs_only", "garbage"])
def test_old_wire_and_obs_sections_still_succeed(trailers):
    """Mirrors ``test_frame_without_digest_still_parses``: a reference
    server with no trailer (the old wire), with an observability section
    after the digest, with one alone, or with bytes that are no section:
    the port's fetch succeeds with the same vector and reads the digest
    exactly when the reference's fetcher does."""
    from dpwa_tpu.obs.wire import encode_obs

    dig = ref_digest.encode_digest(ref_digest.Digest(2, 5, {
        0: ref_digest.MemberEntry(state=1, incarnation=2, suspicion=1.25)}))
    obs = encode_obs(2, 7, 1.5, np.arange(16, dtype=np.float32))
    vec = np.linspace(-1, 1, 300).astype(np.float32)
    srv = ref_tcp.PeerServer("127.0.0.1", 0)
    try:
        kw = {"none": {}, "digest_obs": {"digest": dig, "obs": obs}, "obs_only": {"obs": obs},
              "garbage": {"digest": b"DPWXjunkjunkjunk"}}[trailers]
        srv.publish(vec, 3.0, 0.5, **kw)
        box = []
        got, outcome, _l, nbytes = tcp.fetch_blob_full("127.0.0.1", srv.port, 2000,
                                                       trailer_box=box)
        want = ref_tcp.fetch_blob_full("127.0.0.1", srv.port, 2000, want_digest=True)
        assert outcome == want[1] == "success" and nbytes == want[3] == vec.nbytes
        assert np.array_equal(got[0].numpy(), vec) and box == [want[4]]
        assert box == [dig if trailers == "digest_obs" else None]
    finally:
        srv.close()


def test_port_node_merges_a_peer_without_trailer():
    """An old-wire peer (membership off on a reference node): the port
    node's round succeeds and merges, with nothing merged into its view."""
    kw = dict(schedule="ring", interpolation="constant", factor=0.5)
    ref = ref_tcp.TcpTransport(_ephemeral(ref_config(
        2, base_port=0, membership={"enabled": False}, **kw, **FLOWCTL_OFF)), "node1")
    mine = tcp.TcpTransport(_ephemeral(make_local_config(2, disabled_planes=("flowctl",), **kw)),
                            "node0", device="cpu")
    try:
        for t in (mine, ref):
            t.set_peer_port(0, mine.port)
            t.set_peer_port(1, ref.port)
        ref.publish(np.ones(64, np.float32), 1.0, 0.5)
        merged, alpha, partner = mine.exchange(torch.zeros(64), 1.0, 0.5, 0)
        assert (alpha, partner, mine.last_fetch["outcome"]) == (0.5, 1, "success")
        assert torch.equal(merged, torch.full((64,), 0.5))
        assert mine.membership.view_snapshot()["incarnations"] == {}
    finally:
        mine.close()
        ref.close()


# -- RELAY -------------------------------------------------------------------

@pytest.mark.parametrize("target", ["live", "closed"])
def test_relay_reports_byte_identical_to_reference(target):
    """Mirrors ``test_relay_probe_vouches_for_live_target`` and
    ``test_relay_probe_reports_dead_target``: the same RELAY request to a
    port relay and to a reference relay gets the same report bytes, and
    each package's client reads each relay alike."""
    victim = ref_tcp.PeerServer("127.0.0.1", 0)
    victim.publish(np.zeros(8, np.float32), 42.0, 0.0)
    port = victim.port if target == "live" else _closed_port()
    relays = {"port": tcp.PeerServer("127.0.0.1", 0), "ref": ref_tcp.PeerServer("127.0.0.1", 0)}
    try:
        req = pc.RELAY_REQ + pc.RELAY_BODY.pack(3, port, 200, 9) + b"127.0.0.1"
        replies = {k: _raw_reply(r.port, req) for k, r in relays.items()}
        assert replies["port"] == replies["ref"]
        want = ("success", 42.0) if target == "live" else ("refused", None)
        magic, version, code, clock = pc.RELAY_HDR.unpack(replies["port"])
        assert (magic, version, pc.RELAY_OUTCOME_NAMES[code]) == (b"DPWR", 1, want[0])
        for r in relays.values():
            for client in (tcp.relay_probe, ref_tcp.relay_probe):
                assert client("127.0.0.1", r.port, 3, "127.0.0.1", port, 200, 1000) == (
                    "success", *want)
    finally:
        victim.close()
        for r in relays.values():
            r.close()


def test_relay_client_classifies_a_dead_relay_as_reference():
    port = _closed_port()
    assert tcp.relay_probe("127.0.0.1", port, 1, "127.0.0.1", port, 100, 300) == (
        ref_tcp.relay_probe("127.0.0.1", port, 1, "127.0.0.1", port, 100, 300))
