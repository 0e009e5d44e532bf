"""The port's kubelet sockets: HPACK, HTTP/2 and gRPC written by hand.

``plugin/hpack.py`` alone (every representation, the dynamic table, the
Huffman code and the decoder's refusals, RFC 7541 Appendix C's
examples); then ``plugin/grpc_uds.py`` against real clients and servers:
the ``grpcio`` client and ``curl --http2-prior-knowledge`` (nghttp2,
which Huffman-codes its headers) against the port's server, the port's
client and stubs against the reference's ``grpcio`` ``KubeletPlugin``;
the protocol's cases on a bare socket; and the codes and details an
unknown method and a raising handler give on both packages' servers.

Sockets live under ``tempfile.mkdtemp`` (a short path), never under
``tmp_path``. Every call and every socket read has a timeout, so a hang
fails its test.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import random
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from fractions import Fraction

import grpc
import pytest

from k8s_dra_driver_tpu.kube.protos import dra_v1alpha4_pb2 as ref_drapb
from k8s_dra_driver_tpu.kube.protos import pluginregistration_v1_pb2 as ref_regpb
from k8s_dra_driver_tpu.plugin import grpc_services as ref_services
from k8s_dra_driver_tpu.plugin import kubeletplugin as ref_kubeletplugin
from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb
from k8s_dra_driver_tpu_torch.kube.protos import pluginregistration_v1 as regpb
from k8s_dra_driver_tpu_torch.plugin import grpc_uds, hpack, kubeletplugin
from k8s_dra_driver_tpu_torch.plugin.grpc_services import (
    NodeServicer,
    NodeStub,
    RegistrationStub,
)

DRIVER = "tpu.google.com"
TIMEOUT = 10.0
PREPARE = "/v1alpha3.Node/NodePrepareResources"
GET_INFO = "/pluginregistration.Registration/GetInfo"


# -- HPACK --------------------------------------------------------------------


@pytest.mark.parametrize("value,prefix,encoded", [
    (10, 5, "0a"), (1337, 5, "1f9a0a"), (42, 8, "2a"),     # RFC 7541 C.1
    (0, 1, "00"), (1, 1, "0100"), (127, 7, "7f00"), (2 ** 28, 4, "0ff1ffff7f"),
])
def test_integers_with_an_n_bit_prefix(value, prefix, encoded):
    assert hpack.encode_integer(value, prefix).hex() == encoded
    assert hpack.decode_integer(bytes.fromhex(encoded), 0, prefix) == \
        (value, len(encoded) // 2)


def test_the_huffman_code_is_complete_and_canonical():
    """Kraft's sum over the 257 symbols is exactly 1 (no code is
    missing, none is a prefix of another); EOS is 30 one-bits; and the
    canonical construction gives Appendix B's codes."""
    assert len(hpack.HUFFMAN_LENGTHS) == 257
    assert sum(Fraction(1, 2 ** n) for n in hpack.HUFFMAN_LENGTHS) == 1
    assert hpack.HUFFMAN_CODES[hpack.EOS] == ((1 << 30) - 1, 30)
    known = {0: (0x1ff8, 13), ord(" "): (0x14, 6), ord("0"): (0x0, 5),
             ord("z"): (0x7b, 7), 127: (0xffffffc, 28),
             128: (0xfffe6, 20), 255: (0x3ffffee, 26)}
    for sym, code in known.items():
        assert hpack.HUFFMAN_CODES[sym] == code, sym
    codes = {format(c, f"0{n}b") for c, n in hpack.HUFFMAN_CODES}
    assert len(codes) == 257


@pytest.mark.parametrize("raw,coded", [
    # RFC 7541 C.4 and C.6.
    (b"www.example.com", "f1e3c2e5f23a6ba0ab90f4ff"),
    (b"no-cache", "a8eb10649cbf"),
    (b"custom-key", "25a849e95ba97d7f"),
    (b"custom-value", "25a849e95bb8e8b4bf"),
    (b"302", "6402"),
    (b"private", "aec3771a4b"),
])
def test_huffman_strings_of_the_rfc(raw, coded):
    assert hpack.huffman_encode(raw).hex() == coded
    assert hpack.huffman_decode(bytes.fromhex(coded)) == raw


def test_huffman_round_trips_every_byte():
    rng = random.Random(0)
    samples = [bytes([b]) * 3 for b in range(256)] + [
        bytes(rng.randrange(256) for _ in range(rng.randrange(1, 64)))
        for _ in range(200)]
    for raw in samples:
        assert hpack.huffman_decode(hpack.huffman_encode(raw)) == raw


@pytest.mark.parametrize("coded,why", [
    (hpack.huffman_encode(b"a") + b"\xff", "padding of"),     # 8 pad bits
    (bytes([0b00011000]), "prefix of EOS"),                  # 'a', pad 000
    (b"\xff\xff\xff\xff", "EOS symbol"),                      # EOS + 11
    (b"\xff\xff\xff\xfc", "EOS symbol|no Huffman"),
])
def test_huffman_decoder_refusals(coded, why):
    with pytest.raises(hpack.HpackError, match=why):
        hpack.huffman_decode(coded)


def _nghttp2():
    name = ctypes.util.find_library("nghttp2")
    if name is None:
        pytest.skip("no libnghttp2 on this host")
    return ctypes.CDLL(name)


class _NV(ctypes.Structure):
    _fields_ = [("name", ctypes.POINTER(ctypes.c_uint8)),
                ("value", ctypes.POINTER(ctypes.c_uint8)),
                ("namelen", ctypes.c_size_t), ("valuelen", ctypes.c_size_t),
                ("flags", ctypes.c_uint8)]


def nghttp2_inflate(block: bytes) -> list:
    """nghttp2's HPACK decoder on one header block."""
    lib = _nghttp2()
    lib.nghttp2_hd_inflate_hd2.restype = ctypes.c_ssize_t
    inflater = ctypes.c_void_p()
    assert lib.nghttp2_hd_inflate_new(ctypes.byref(inflater)) == 0
    buf = (ctypes.c_uint8 * max(1, len(block))).from_buffer_copy(
        block or b"\0")
    out, pos = [], 0
    try:
        while True:
            nv, flags = _NV(), ctypes.c_int(0)
            n = lib.nghttp2_hd_inflate_hd2(
                inflater, ctypes.byref(nv), ctypes.byref(flags),
                ctypes.byref(buf, pos), len(block) - pos, 1)
            assert n >= 0, f"nghttp2 refused the block: {n}"
            pos += n
            if flags.value & 0x2:
                out.append((ctypes.string_at(nv.name, nv.namelen).decode(),
                            ctypes.string_at(nv.value, nv.valuelen).decode(
                                "latin-1")))
            if flags.value & 0x1:
                return out
    finally:
        lib.nghttp2_hd_inflate_del(inflater)


def test_nghttp2_decodes_the_huffman_code_and_the_encoder():
    """nghttp2's decoder reads every symbol of the port's Huffman code,
    and the port encoder's blocks."""
    for b in range(256):
        value = bytes([b, b, 0x61]).decode("latin-1")
        block = hpack.encode_literal("k", value, huffman=True)
        assert nghttp2_inflate(block) == [("k", value)], b
    enc = hpack.Encoder()
    fields = [(":status", "200"), ("content-type", "application/grpc"),
              ("grpc-message", "a%20b")]
    assert nghttp2_inflate(enc.encode(fields)) == fields


@pytest.mark.parametrize("kind", ["indexed", "with", "with-name-index",
                                  "without", "never"])
@pytest.mark.parametrize("huffman", [False, True])
def test_every_representation_round_trips(kind, huffman):
    """Each field representation decodes to its field; a literal with
    incremental indexing enters the dynamic table as index 62, the
    others do not."""
    if kind == "indexed":
        block, want = hpack.encode_indexed(8), (":status", "200")
    elif kind == "with-name-index":
        block = hpack.encode_literal(31, "application/grpc",
                                     hpack.WITH_INDEXING, huffman)
        want = ("content-type", "application/grpc")
    else:
        rep = {"with": hpack.WITH_INDEXING, "without": hpack.WITHOUT_INDEXING,
               "never": hpack.NEVER_INDEXED}[kind]
        block = hpack.encode_literal("grpc-status", "0", rep, huffman)
        want = ("grpc-status", "0")
    dec = hpack.Decoder()
    assert dec.decode(block) == [want]
    indexed = kind in ("with", "with-name-index")
    assert list(dec.table) == ([want] if indexed else [])
    if indexed:
        assert dec.decode(hpack.encode_indexed(62)) == [want]
    else:
        with pytest.raises(hpack.HpackError, match="past the dynamic"):
            dec.decode(hpack.encode_indexed(62))


def test_rfc_request_examples_share_one_dynamic_table():
    """RFC 7541 C.3 (raw) and C.4 (Huffman): three requests on one
    connection; the table's size after each."""
    for blocks in (
            ["828684410f7777772e6578616d706c652e636f6d",
             "828684be58086e6f2d6361636865",
             "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"],
            ["828684418cf1e3c2e5f23a6ba0ab90f4ff",
             "828684be5886a8eb10649cbf",
             "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"]):
        dec = hpack.Decoder()
        got = [dec.decode(bytes.fromhex(b)) for b in blocks]
        assert got[0] == [(":method", "GET"), (":scheme", "http"),
                          (":path", "/"), (":authority", "www.example.com")]
        assert got[1][-1] == ("cache-control", "no-cache")
        assert got[2] == [(":method", "GET"), (":scheme", "https"),
                          (":path", "/index.html"),
                          (":authority", "www.example.com"),
                          ("custom-key", "custom-value")]
        assert dec.size == 164
        assert [n for n, _ in dec.table] == ["custom-key", "cache-control",
                                             ":authority"]


def test_dynamic_table_eviction_and_size_updates():
    dec = hpack.Decoder(max_allowed=4096)
    dec.decode(hpack.encode_size_update(100))      # room for 100 bytes
    a = hpack.encode_literal("a", "x" * 30, hpack.WITH_INDEXING)   # 63
    b = hpack.encode_literal("b", "y" * 10, hpack.WITH_INDEXING)   # 43
    dec.decode(a)
    assert dec.size == 63
    dec.decode(b)                                  # 106 > 100: a goes
    assert list(dec.table) == [("b", "y" * 10)] and dec.size == 43
    dec.decode(hpack.encode_literal("c", "z" * 200, hpack.WITH_INDEXING))
    assert not dec.table and dec.size == 0         # too big: table empty
    dec.decode(b)
    dec.decode(hpack.encode_size_update(0))        # 0 evicts everything
    assert not dec.table and dec.size == 0
    with pytest.raises(hpack.HpackError, match="over the 4096 allowed"):
        dec.decode(hpack.encode_size_update(4097))
    with pytest.raises(hpack.HpackError, match="after a field"):
        dec.decode(hpack.encode_indexed(2) + hpack.encode_size_update(10))
    with pytest.raises(hpack.HpackError, match="index 0"):
        dec.decode(hpack.encode_indexed(0))
    with pytest.raises(hpack.HpackError, match="past the end"):
        dec.decode(b"\x1f")


def test_encoder_owes_a_size_update_after_the_peer_lowers_its_table():
    enc = hpack.Encoder()
    assert enc.encode([(":status", "200")]) == b"\x88"
    enc.set_peer_table_size(8192)                  # higher: nothing owed
    assert enc.encode([(":status", "200")]) == b"\x88"
    enc.set_peer_table_size(0)
    block = enc.encode([(":status", "200")])
    assert block == b"\x20\x88"
    assert enc.encode([(":status", "200")]) == b"\x88"
    dec = hpack.Decoder()
    assert dec.decode(block) == [(":status", "200")] and dec.max_size == 0


# -- servers and clients ------------------------------------------------------


@pytest.fixture
def sockdir():
    path = tempfile.mkdtemp(prefix="ks-")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def port_reply(request, devices: int):
    resp = drapb.NodePrepareResourcesResponse()
    for c in request.claims:
        resp.claims[c.uid] = drapb.NodePrepareResourceResponse(devices=[
            drapb.Device(request_names=["r"], pool_name="node-a",
                         device_name=f"tpu-{i}",
                         cdi_device_ids=[f"{DRIVER}/claim={c.uid}-{i}"])
            for i in range(devices)])
    return resp


class PortNode(NodeServicer):
    """A node service whose prepare answers ``devices`` devices per
    claim, after ``gate()`` returns; ``fail`` makes it raise."""

    def __init__(self, devices=1, gate=None, fail=None):
        self.devices, self.gate, self.fail = devices, gate, fail

    def NodePrepareResources(self, request, context):
        if self.fail:
            raise RuntimeError(self.fail)
        if self.gate is not None:
            self.gate()
        return port_reply(request, self.devices)

    def NodeUnprepareResources(self, request, context):
        return drapb.NodeUnprepareResourcesResponse(claims={
            c.uid: drapb.NodeUnprepareResourceResponse() for c in request.claims})


class RefNode(ref_services.NodeServicer):
    def __init__(self, devices=1, fail=None):
        self.devices, self.fail = devices, fail

    def NodePrepareResources(self, request, context):
        if self.fail:
            raise RuntimeError(self.fail)
        resp = ref_drapb.NodePrepareResourcesResponse()
        for c in request.claims:
            for i in range(self.devices):
                resp.claims[c.uid].devices.add(
                    request_names=["r"], pool_name="node-a",
                    device_name=f"tpu-{i}",
                    cdi_device_ids=[f"{DRIVER}/claim={c.uid}-{i}"])
        return resp

    def NodeUnprepareResources(self, request, context):
        return ref_drapb.NodeUnprepareResourcesResponse()


def port_plugin(root, node, transport=None):
    plugin = kubeletplugin.KubeletPlugin(
        node, DRIVER, "node-a", plugin_socket=f"{root}/p/dra.sock",
        registrar_socket=f"{root}/g/{DRIVER}-dra.sock",
        transport=transport if transport is not None
        else grpc_uds.SocketTransport())
    plugin.start()
    return plugin


def ref_plugin(root, node):
    plugin = ref_kubeletplugin.KubeletPlugin(
        node, DRIVER, "node-a", plugin_socket=f"{root}/rp/dra.sock",
        registrar_socket=f"{root}/rg/{DRIVER}-dra.sock")
    plugin.start()
    return plugin


def claims(n, prefix="c"):
    return [drapb.Claim(uid=f"{prefix}-{i:05d}", name=f"claim-{i}",
                        namespace="default") for i in range(n)]


def test_grpcio_client_against_the_port_server(sockdir):
    """The reference's grpcio stubs register with the port's plugin and
    prepare under both service names; the replies are the port codec's
    bytes, read by protobuf."""
    plugin = port_plugin(sockdir, PortNode(devices=2))
    try:
        assert plugin.serving and DRIVER in plugin.transport.detail
        with grpc.insecure_channel(f"unix://{plugin.registrar_socket}") as ch:
            stub = ref_services.RegistrationStub(ch)
            info = stub.GetInfo(ref_regpb.InfoRequest(), timeout=TIMEOUT)
            stub.NotifyRegistrationStatus(ref_regpb.RegistrationStatus(
                plugin_registered=True), timeout=TIMEOUT)
        assert (info.type, info.name, info.endpoint) == (
            "DRAPlugin", DRIVER, plugin.plugin_socket)
        assert plugin.registration_status() == {"pluginRegistered": True,
                                                "error": ""}
        for service in (ref_services.DRA_SERVICE_NAME,
                        ref_services.DRA_SERVICE_NAME_V1BETA1):
            with grpc.insecure_channel(f"unix://{plugin.plugin_socket}") as ch:
                resp = ref_services.NodeStub(ch, service_name=service) \
                    .NodePrepareResources(ref_drapb.NodePrepareResourcesRequest(
                        claims=[ref_drapb.Claim(uid="u1", name="c")]),
                        timeout=TIMEOUT)
            assert [d.device_name for d in resp.claims["u1"].devices] == \
                ["tpu-0", "tpu-1"]
    finally:
        plugin.stop()
    assert not os.path.exists(plugin.plugin_socket)
    assert not os.path.exists(plugin.registrar_socket)


def test_curl_with_nghttp2_against_the_port_server(sockdir):
    """curl (nghttp2, Huffman-coded headers) sends a gRPC-framed GetInfo
    with prior knowledge; the body decodes with the port's codec."""
    if shutil.which("curl") is None:
        pytest.skip("no curl on this host")
    plugin = port_plugin(sockdir, PortNode())
    try:
        request = f"{sockdir}/req"
        with open(request, "wb") as f:
            f.write(grpc_uds.grpc_frame(regpb.InfoRequest().SerializeToString()))
        proc = subprocess.run(
            ["curl", "-sS", "--max-time", "10", "--http2-prior-knowledge",
             "--unix-socket", plugin.registrar_socket,
             f"http://localhost{GET_INFO}",
             "-H", "content-type: application/grpc", "-H", "te: trailers",
             "--data-binary", f"@{request}", "-D", f"{sockdir}/headers",
             "-o", f"{sockdir}/body"],
            capture_output=True, text=True, timeout=30)
        assert proc.returncode == 0, proc.stderr
        with open(f"{sockdir}/body", "rb") as f:
            body = f.read()
        with open(f"{sockdir}/headers") as f:
            headers = f.read()
    finally:
        plugin.stop()
    assert headers.startswith("HTTP/2 200")
    assert "content-type: application/grpc" in headers
    assert "grpc-status: 0" in headers        # the trailers
    assert body[:1] == b"\0" and int.from_bytes(body[1:5], "big") == \
        len(body) - 5
    info = regpb.PluginInfo.FromString(body[5:])
    assert (info.name, info.endpoint) == (DRIVER, plugin.plugin_socket)


def test_port_client_and_stubs_against_the_grpcio_server(sockdir):
    """The port's Channel, NodeStub and RegistrationStub against the
    reference's grpcio KubeletPlugin."""
    plugin = ref_plugin(sockdir, RefNode(devices=3))
    try:
        with grpc_uds.Channel(plugin.registrar_socket) as ch:
            info = RegistrationStub(ch).GetInfo(regpb.InfoRequest(),
                                                timeout=TIMEOUT)
            RegistrationStub(ch).NotifyRegistrationStatus(
                regpb.RegistrationStatus(plugin_registered=False,
                                         error="nope"), timeout=TIMEOUT)
        assert info.endpoint == plugin.plugin_socket
        assert plugin.registration_status() == {"pluginRegistered": False,
                                                "error": "nope"}
        with grpc_uds.Channel(plugin.plugin_socket) as ch:
            for service in (ref_services.DRA_SERVICE_NAME,
                            ref_services.DRA_SERVICE_NAME_V1BETA1):
                resp = NodeStub(ch, service_name=service).NodePrepareResources(
                    drapb.NodePrepareResourcesRequest(claims=claims(4)),
                    timeout=TIMEOUT)
                assert sorted(resp.claims) == [c.uid for c in claims(4)]
                assert [d.device_name for d in resp.claims["c-00002"].devices
                        ] == ["tpu-0", "tpu-1", "tpu-2"]
            with pytest.raises(grpc_uds.RpcError) as err:
                ch.call("/v1alpha3.Node/Nope", b"", TIMEOUT)
            assert err.value.code() == grpc_uds.UNIMPLEMENTED
    finally:
        plugin.stop()


@pytest.mark.parametrize("client", ["port", "grpcio"])
def test_request_and_reply_over_64_kib_are_flow_controlled(sockdir, client):
    """A 4500-claim prepare (about 140 KB) and its reply of 4 devices a
    claim (about 1 MB) pass the default 65,535-byte windows both ways."""
    plugin = port_plugin(sockdir, PortNode(devices=4))
    request = drapb.NodePrepareResourcesRequest(claims=claims(4500))
    want = port_reply(request, 4)
    assert len(request.SerializeToString()) > 2 * 65535
    assert len(want.SerializeToString()) > 8 * 65535
    try:
        if client == "port":
            with grpc_uds.Channel(plugin.plugin_socket) as ch:
                got = NodeStub(ch).NodePrepareResources(request,
                                                        timeout=TIMEOUT)
            assert got == want
        else:
            with grpc.insecure_channel(f"unix://{plugin.plugin_socket}") as ch:
                raw = ch.unary_unary(PREPARE)(request.SerializeToString(),
                                             timeout=TIMEOUT)
            assert raw == want.SerializeToString()
    finally:
        plugin.stop()


def test_eight_concurrent_calls_share_one_channel(sockdir):
    """Eight threads call at once on one connection: each handler waits
    at a barrier of 8, so all eight streams are in the pool together."""
    barrier = threading.Barrier(8, timeout=TIMEOUT)
    plugin = port_plugin(sockdir, PortNode(gate=barrier.wait))
    results, errors = {}, []
    try:
        with grpc_uds.Channel(plugin.plugin_socket) as ch:
            def one(i):
                try:
                    results[i] = NodeStub(ch).NodePrepareResources(
                        drapb.NodePrepareResourcesRequest(
                            claims=claims(1, prefix=f"t{i}")),
                        timeout=TIMEOUT)
                except Exception as e:   # surfaced below
                    errors.append(e)
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT + 5)
            assert len(plugin.transport._servers["dra"].connections) == 1
    finally:
        plugin.stop()
    assert not errors, errors
    assert sorted(results) == list(range(8))
    assert all(list(r.claims) == [f"t{i}-00000"] for i, r in results.items())


def test_stress_many_threads_on_one_channel(sockdir):
    """32 threads (more than the cores and the pool's 8 workers) make 10
    calls each on one connection, with a short switch interval: every
    reply carries its own request's claim, so no stream's frames were
    crossed or lost."""
    plugin = port_plugin(sockdir, PortNode(devices=3))
    switch = sys.getswitchinterval()
    errors, done = [], []
    try:
        sys.setswitchinterval(1e-5)
        with grpc_uds.Channel(plugin.plugin_socket) as ch:
            def worker(i):
                try:
                    for j in range(10):
                        uid = f"w{i:02d}-{j}"
                        got = NodeStub(ch).NodePrepareResources(
                            drapb.NodePrepareResourcesRequest(
                                claims=[drapb.Claim(uid=uid)]),
                            timeout=TIMEOUT)
                        assert list(got.claims) == [uid], (uid, got)
                        assert got.claims[uid].devices[2].cdi_device_ids \
                            == [f"{DRIVER}/claim={uid}-2"]
                    done.append(i)
                except Exception as e:   # surfaced below
                    errors.append(e)
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT * 3)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        plugin.stop()
    assert not errors, errors[:3]
    assert sorted(done) == list(range(32))


def test_a_cancelled_call_leaves_the_connection_serving(sockdir):
    """A call whose deadline passes sends RST_STREAM; the server drops
    that stream and answers the next call on the same connection."""
    release = threading.Event()
    calls = []

    def gate():
        calls.append(1)
        if len(calls) == 1:
            release.wait(TIMEOUT)

    plugin = port_plugin(sockdir, PortNode(gate=gate))
    try:
        with grpc_uds.Channel(plugin.plugin_socket) as ch:
            request = drapb.NodePrepareResourcesRequest(claims=claims(1))
            with pytest.raises(grpc_uds.RpcError) as err:
                NodeStub(ch).NodePrepareResources(request, timeout=0.3)
            assert err.value.code() == grpc_uds.DEADLINE_EXCEEDED
            server = plugin.transport._servers["dra"]
            (conn,) = server.connections
            deadline = time.monotonic() + TIMEOUT
            while conn.streams and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not conn.streams            # the reset stream is gone
            release.set()
            got = NodeStub(ch).NodePrepareResources(request, timeout=TIMEOUT)
            assert list(got.claims) == ["c-00000"] and ch.usable
            assert len(server.connections) == 1
    finally:
        release.set()
        plugin.stop()


def ping_acks_written(monkeypatch) -> list:
    """The PING ACK frames the server's readers write, as they go on
    the wire."""
    acks = []
    answer = grpc_uds._Connection._answer

    def recording(self, frames):
        off = 0
        while off < len(frames):
            length_type, flags, _ = grpc_uds._FRAME_HEADER.unpack_from(
                frames, off)
            if length_type & 0xFF == grpc_uds.PING and flags & grpc_uds.ACK:
                acks.append(bytes(frames[off + 9:off + 9 + 8]))
            off += 9 + (length_type >> 8)
        answer(self, frames)

    monkeypatch.setattr(grpc_uds._Connection, "_answer", recording)
    return acks


def test_keepalive_pings_are_answered(sockdir, monkeypatch):
    """A grpcio channel with a 50 ms keepalive and a 500 ms keepalive
    timeout holds a call open for 1.2 s: its keepalive PINGs must be
    ACKed in time, or grpcio drops the connection and the call fails."""
    acks = ping_acks_written(monkeypatch)
    plugin = port_plugin(sockdir, PortNode(gate=lambda: time.sleep(1.2)))
    options = [("grpc.keepalive_time_ms", 50),
               ("grpc.keepalive_timeout_ms", 500),
               ("grpc.keepalive_permit_without_calls", 1),
               ("grpc.http2.max_pings_without_data", 0)]
    try:
        with grpc.insecure_channel(f"unix://{plugin.plugin_socket}",
                                   options=options) as ch:
            resp = ref_services.NodeStub(ch).NodePrepareResources(
                ref_drapb.NodePrepareResourcesRequest(
                    claims=[ref_drapb.Claim(uid="u1")]), timeout=TIMEOUT)
        assert list(resp.claims) == ["u1"]
        assert len(acks) >= 2       # BDP's and keepalive's
    finally:
        plugin.stop()


def test_stop_sends_goaway_and_lets_an_in_flight_call_finish(sockdir):
    started = threading.Event()

    def gate():
        started.set()
        time.sleep(0.3)

    plugin = port_plugin(sockdir, PortNode(gate=gate))
    got = {}
    ch = grpc_uds.Channel(plugin.plugin_socket)
    try:
        def call():
            got["reply"] = NodeStub(ch).NodePrepareResources(
                drapb.NodePrepareResourcesRequest(claims=claims(1)),
                timeout=TIMEOUT)
        t = threading.Thread(target=call)
        t.start()
        assert started.wait(TIMEOUT)
        t0 = time.monotonic()
        plugin.stop()
        stop_s = time.monotonic() - t0
        t.join(TIMEOUT)
        assert list(got["reply"].claims) == ["c-00000"]
        assert 0.1 < stop_s < grpc_uds.GRACE_S + 1
        assert ch._conn.goaway_last == 1 and not ch.usable
        assert not plugin.serving
        assert not os.path.exists(plugin.plugin_socket)
        assert not os.path.exists(plugin.registrar_socket)
    finally:
        ch.close()
        plugin.stop()


def test_a_stale_socket_file_is_replaced_at_start(sockdir):
    for path in (f"{sockdir}/p/dra.sock", f"{sockdir}/g/{DRIVER}-dra.sock"):
        os.makedirs(os.path.dirname(path))
        stale = socket.socket(socket.AF_UNIX)
        stale.bind(path)            # bound, then left behind
        stale.close()
    plugin = port_plugin(sockdir, PortNode())
    try:
        with grpc_uds.Channel(plugin.plugin_socket) as ch:
            got = NodeStub(ch).NodePrepareResources(
                drapb.NodePrepareResourcesRequest(claims=claims(1)),
                timeout=TIMEOUT)
        assert list(got.claims) == ["c-00000"]
    finally:
        plugin.stop()


def test_a_path_over_the_af_unix_limit_is_refused(sockdir):
    long_dir = os.path.join(sockdir, "d" * (108 - len(sockdir)))
    plugin = kubeletplugin.KubeletPlugin(
        PortNode(), DRIVER, "node-a", plugin_socket=f"{long_dir}/dra.sock",
        registrar_socket=f"{sockdir}/g/reg.sock",
        transport=grpc_uds.SocketTransport())
    with pytest.raises(ValueError, match="over the AF_UNIX limit of 107"):
        plugin.start()
    assert not plugin.serving
    assert not os.path.exists(long_dir)
    assert not os.path.exists(f"{sockdir}/g")
    grpc_uds.check_socket_path("/" + "x" * 106)     # 107 bytes: fine


@pytest.mark.parametrize("case", ["unknown method", "raising handler"])
def test_error_codes_and_details_match_grpcio(sockdir, case):
    """The same failing call on the reference's grpcio server and on the
    port's gives the same ``code()`` and ``details()``."""
    fail = "boom: 100% of the ünïcode" if case == "raising handler" else None
    method = "/v1alpha3.Node/NoSuchMethod" if case == "unknown method" \
        else PREPARE
    ref = ref_plugin(sockdir, RefNode(fail=fail))
    port = port_plugin(sockdir, PortNode(fail=fail))
    seen = []
    try:
        for plugin in (ref, port):
            with grpc.insecure_channel(f"unix://{plugin.plugin_socket}") as ch:
                with pytest.raises(grpc.RpcError) as err:
                    ch.unary_unary(method)(b"", timeout=TIMEOUT)
            seen.append((err.value.code(), err.value.details()))
        with grpc_uds.Channel(port.plugin_socket) as ch:
            with pytest.raises(grpc_uds.RpcError) as err:
                ch.call(method, b"", TIMEOUT)
        seen.append((err.value.code(), err.value.details()))
    finally:
        ref.stop()
        port.stop()
    want = (grpc.StatusCode.UNIMPLEMENTED, "Method not found!") \
        if fail is None else (grpc.StatusCode.UNKNOWN,
                              f"Exception calling application: {fail}")
    assert seen[0] == seen[1] == want
    assert seen[2] == (want[0].value[0], want[1])


def test_transport_call_goes_over_the_socket(sockdir):
    """``SocketTransport.call`` keeps ``LocalTransport.call``'s signature
    and answers the same bytes, through its client over the sockets."""
    node = PortNode(devices=2)
    sock = port_plugin(sockdir, node)
    local = port_plugin(sockdir, node, transport=kubeletplugin.LocalTransport())
    request = drapb.NodePrepareResourcesRequest(claims=claims(3))
    try:
        for path in (PREPARE, "/v1beta1.DRAPlugin/NodePrepareResources",
                     GET_INFO):
            body = (request if path != GET_INFO
                    else regpb.InfoRequest()).SerializeToString()
            assert sock.transport.call(path, body) == \
                local.transport.call(path, body)
        assert sock.transport.socket_of(GET_INFO) == sock.registrar_socket
        assert sock.transport.socket_of(PREPARE) == sock.plugin_socket
        with pytest.raises(grpc_uds.RpcError) as err:
            sock.transport.call("/pluginregistration.Registration/Nope", b"")
        assert err.value.code() == grpc_uds.UNIMPLEMENTED
    finally:
        sock.stop()
        local.stop()
    with pytest.raises(RuntimeError, match="not serving"):
        sock.transport.call(PREPARE, b"")


# -- the protocol on a bare socket --------------------------------------------


class Raw:
    """A bare HTTP/2 client: frames written and read as they are."""

    def __init__(self, path, settings=()):
        self.sock = socket.socket(socket.AF_UNIX)
        self.sock.settimeout(TIMEOUT)
        self.sock.connect(path)
        self.enc, self.dec = hpack.Encoder(), hpack.Decoder()
        self.buf = b""
        self.sock.sendall(grpc_uds.PREFACE)
        self.send(grpc_uds.SETTINGS, 0, 0, b"".join(
            struct.pack(">HI", k, v) for k, v in settings))

    def send(self, ftype, flags, sid, payload=b""):
        self.sock.sendall(struct.pack(">IBI", len(payload) << 8 | ftype,
                                      flags, sid) + payload)

    def read(self):
        """(type, flags, stream id, payload) of the next frame; None at
        EOF."""
        while len(self.buf) < 9 or \
                len(self.buf) < 9 + int.from_bytes(self.buf[:3], "big"):
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self.buf += chunk
        n = int.from_bytes(self.buf[:3], "big")
        frame = (self.buf[3], self.buf[4],
                 int.from_bytes(self.buf[5:9], "big"), self.buf[9:9 + n])
        self.buf = self.buf[9 + n:]
        return frame

    def request(self, sid, path, message=b"", compressed=False):
        block = self.enc.encode([(":method", "POST"), (":scheme", "http"),
                                 (":path", path),
                                 ("content-type", "application/grpc")])
        self.send(grpc_uds.HEADERS, grpc_uds.END_HEADERS, sid, block)
        self.send(grpc_uds.DATA, grpc_uds.END_STREAM, sid,
                  struct.pack(">BI", int(compressed), len(message)) + message)

    def reply(self, sid, frames=None):
        """(header blocks, data) of stream ``sid`` up to END_STREAM;
        every frame seen is appended to ``frames``."""
        blocks, data = [], b""
        while True:
            frame = self.read()
            assert frame is not None, "EOF before the reply ended"
            ftype, flags, fsid, payload = frame
            if frames is not None:
                frames.append(frame)
            if ftype == grpc_uds.HEADERS:
                blocks.append(payload)
                fields = self.dec.decode(payload)
            if fsid != sid:
                continue
            if ftype == grpc_uds.HEADERS:
                blocks[-1] = dict(fields)
            elif ftype == grpc_uds.DATA:
                data += payload
            if ftype in (grpc_uds.HEADERS, grpc_uds.DATA) and \
                    flags & grpc_uds.END_STREAM:
                return blocks, data

    def close(self):
        self.sock.close()


@pytest.fixture
def server(sockdir):
    plugin = port_plugin(sockdir, PortNode(devices=8))
    yield plugin
    plugin.stop()


def test_ping_is_answered_with_its_payload(server):
    raw = Raw(server.registrar_socket)
    try:
        raw.send(grpc_uds.PING, 0, 0, b"12345678")
        frames = []
        while not frames or frames[-1][0] != grpc_uds.PING:
            frames.append(raw.read())
        assert frames[-1] == (grpc_uds.PING, grpc_uds.ACK, 0, b"12345678")
        kinds = [f[0] for f in frames]
        assert kinds[0] == grpc_uds.SETTINGS     # the server's preface
        assert (grpc_uds.SETTINGS, grpc_uds.ACK, 0, b"") in frames
    finally:
        raw.close()


def test_push_promise_from_a_client_is_a_connection_error(server):
    raw = Raw(server.registrar_socket)
    try:
        raw.send(grpc_uds.PUSH_PROMISE, grpc_uds.END_HEADERS, 1,
                 b"\0\0\0\2\x88")
        frames = []
        while (frame := raw.read()) is not None:
            frames.append(frame)
        ftype, _, _, payload = frames[-1]
        assert ftype == grpc_uds.GOAWAY
        assert int.from_bytes(payload[4:8], "big") == grpc_uds.PROTOCOL_ERROR
    finally:
        raw.close()


def test_priority_unknown_frames_padding_and_continuation(server):
    """PRIORITY and an unknown frame type are ignored; HEADERS with the
    PADDED and PRIORITY flags, split over a CONTINUATION, and padded
    DATA make a request like any other; every DATA frame read is given
    back with WINDOW_UPDATE on the connection and the stream."""
    raw = Raw(server.plugin_socket)
    try:
        raw.send(grpc_uds.PRIORITY, 0, 1, b"\0\0\0\0\x10")
        raw.send(0xFA, 0xFF, 0, b"whatever")
        block = raw.enc.encode([(":method", "POST"), (":scheme", "http"),
                                (":path", PREPARE),
                                ("content-type", "application/grpc")])
        pad = b"\0" * 7
        raw.send(grpc_uds.HEADERS, grpc_uds.PADDED | grpc_uds.PRIORITY_FLAG,
                 1, bytes([len(pad)]) + b"\0\0\0\0\x10" + block[:5] + pad)
        raw.send(grpc_uds.CONTINUATION, grpc_uds.END_HEADERS, 1, block[5:])
        message = drapb.NodePrepareResourcesRequest(
            claims=claims(2)).SerializeToString()
        body = struct.pack(">BI", 0, len(message)) + message
        raw.send(grpc_uds.DATA, grpc_uds.PADDED, 1,
                 b"\3" + body[:10] + b"\0\0\0")
        raw.send(grpc_uds.DATA, grpc_uds.END_STREAM, 1, body[10:])
        frames = []
        (head, trailers), data = raw.reply(1, frames)
        assert head[":status"] == "200" and trailers["grpc-status"] == "0"
        got = drapb.NodePrepareResourcesResponse.FromString(data[5:])
        assert sorted(got.claims) == ["c-00000", "c-00001"]
        updates = [(sid, int.from_bytes(p, "big")) for t, _, sid, p in frames
                   if t == grpc_uds.WINDOW_UPDATE]
        assert (0, 14) in updates and (1, 14) in updates
    finally:
        raw.close()


def test_the_clients_settings_are_honoured(server):
    """HEADER_TABLE_SIZE 0: the reply's first block opens with a size
    update to 0. INITIAL_WINDOW_SIZE 1000: the server sends 1000 bytes
    of DATA and waits for WINDOW_UPDATE. MAX_FRAME_SIZE 20000: no frame
    is larger."""
    raw = Raw(server.plugin_socket, settings=[
        (grpc_uds.SETTINGS_HEADER_TABLE_SIZE, 0),
        (grpc_uds.SETTINGS_INITIAL_WINDOW_SIZE, 1000),
        (grpc_uds.SETTINGS_MAX_FRAME_SIZE, 20000)])
    try:
        while raw.read()[:2] != (grpc_uds.SETTINGS, grpc_uds.ACK):
            pass
        request = drapb.NodePrepareResourcesRequest(claims=claims(60))
        raw.request(1, PREPARE, request.SerializeToString())
        frames = []
        while sum(len(p) for t, _, _, p in frames if t == grpc_uds.DATA) \
                < 1000:
            frames.append(raw.read())
        raw.sock.settimeout(0.3)
        with pytest.raises(socket.timeout):
            raw.read()                       # the stream window is spent
        raw.sock.settimeout(TIMEOUT)
        (head_frame,) = [f for f in frames if f[0] == grpc_uds.HEADERS]
        assert head_frame[3][:1] == b"\x20"  # size update to 0
        raw.dec.decode(head_frame[3])
        raw.send(grpc_uds.WINDOW_UPDATE, 0, 1, (1 << 20).to_bytes(4, "big"))
        rest = []
        (trailers,), tail = raw.reply(1, rest)
        data = b"".join(p for t, _, _, p in frames if t == grpc_uds.DATA) + \
            tail
        assert trailers["grpc-status"] == "0"
        assert drapb.NodePrepareResourcesResponse.FromString(data[5:]) == \
            port_reply(request, 8)
        assert len(data) > 20000 and max(
            len(f[3]) for f in frames + rest) <= 20000
    finally:
        raw.close()


def test_a_compressed_message_without_a_supported_encoding(server):
    raw = Raw(server.plugin_socket)
    try:
        raw.request(1, PREPARE, b"\x1f\x8b", compressed=True)
        (fields,), data = raw.reply(1)
        assert data == b"" and fields[":status"] == "200"
        assert fields["grpc-status"] == str(grpc_uds.UNIMPLEMENTED)
        raw.request(3, GET_INFO.replace("Registration", "Nope"), b"")
        (fields,), _ = raw.reply(3)
        assert fields["grpc-status"] == str(grpc_uds.UNIMPLEMENTED)
        assert fields["grpc-message"] == "Method not found!"
    finally:
        raw.close()


def test_grpc_message_percent_encoding_round_trips():
    text = "bad: 100% ü\nend"
    encoded = grpc_uds.percent_encode(text)
    assert encoded == "bad: 100%25 %C3%BC%0Aend"
    assert grpc_uds.percent_decode(encoded) == text
    assert grpc_uds.percent_decode("50%") == "50%"
