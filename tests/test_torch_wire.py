"""The port's hand-written proto3 codec against the reference's generated
``_pb2`` classes.

For seeded random instances of every DRA and plugin-registration message
(empty, unicode, repeated and map fields), the port's
``SerializeToString()`` must equal the ``_pb2``'s
``SerializeToString(deterministic=True)`` byte for byte, and each side's
``FromString`` must read the other's bytes back to equal fields. Unknown
fields, and known fields met with another wire type, are skipped.
"""

from __future__ import annotations

import random

import pytest

from k8s_dra_driver_tpu.kube.protos import dra_v1alpha4_pb2 as ref_dra
from k8s_dra_driver_tpu.kube.protos import pluginregistration_v1_pb2 as ref_reg
from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as dra
from k8s_dra_driver_tpu_torch.kube.protos import pluginregistration_v1 as reg
from k8s_dra_driver_tpu_torch.kube.protos import wire

MESSAGES = [(cls, getattr(ref_dra, cls.__name__)) for cls in dra.MESSAGES] + \
    [(cls, getattr(ref_reg, cls.__name__)) for cls in reg.MESSAGES]
ALPHABET = "abcXYZ019-_./=: éü漢字🙂\n\x00"


def random_text(rng):
    if rng.random() < 0.25:
        return ""
    return "".join(rng.choice(ALPHABET) for _ in range(rng.randint(1, 12)))


def random_fields(cls, rng, depth=0):
    """Field values of a random instance, as plain Python (nested
    messages as dicts of their own)."""
    out = {}
    for f in cls.FIELDS:
        if f.kind == wire.BOOL:
            out[f.name] = rng.random() < 0.5
        elif f.kind == wire.STRING:
            out[f.name] = ([random_text(rng) for _ in range(rng.randint(0, 3))]
                           if f.repeated else random_text(rng))
        elif f.kind == wire.MESSAGE:
            out[f.name] = [random_fields(f.message, rng, depth + 1)
                           for _ in range(rng.randint(0, 3))]
        else:
            out[f.name] = {random_text(rng): random_fields(f.message, rng,
                                                           depth + 1)
                           for _ in range(rng.randint(0, 3))}
    return out


def port_message(cls, fields):
    kwargs = {}
    for f in cls.FIELDS:
        v = fields[f.name]
        if f.kind == wire.MESSAGE:
            v = [port_message(f.message, x) for x in v]
        elif f.kind == wire.MAP:
            v = {k: port_message(f.message, x) for k, x in v.items()}
        kwargs[f.name] = v
    return cls(**kwargs)


def fill_ref(msg, cls, fields):
    for f in cls.FIELDS:
        v = fields[f.name]
        if f.kind == wire.MESSAGE:
            for x in v:
                fill_ref(getattr(msg, f.name).add(), f.message, x)
        elif f.kind == wire.MAP:
            for k, x in v.items():
                fill_ref(getattr(msg, f.name)[k], f.message, x)
        elif f.repeated:
            getattr(msg, f.name).extend(v)
        else:
            setattr(msg, f.name, v)
    return msg


@pytest.mark.parametrize("port_cls,ref_cls", MESSAGES,
                         ids=[c.__name__ for c, _ in MESSAGES])
def test_bytes_equal_and_decode_both_ways(port_cls, ref_cls):
    rng = random.Random(f"wire-{port_cls.__name__}")
    for i in range(60):
        fields = random_fields(port_cls, rng)
        mine = port_message(port_cls, fields)
        theirs = fill_ref(ref_cls(), port_cls, fields)
        ref_bytes = theirs.SerializeToString(deterministic=True)
        assert mine.SerializeToString() == ref_bytes, (i, fields)
        assert port_cls.FromString(ref_bytes) == mine
        assert ref_cls.FromString(mine.SerializeToString()) == theirs
    # The empty message: no bytes at all.
    assert port_cls().SerializeToString() == b"" == \
        ref_cls().SerializeToString(deterministic=True)


def test_driver_shaped_messages():
    """The messages as the Driver builds them: an in-band error beside a
    prepared claim, an empty unprepare reply, a v1beta1 GetInfo."""
    mine = dra.NodePrepareResourcesResponse()
    mine.claims["uid-b"] = dra.NodePrepareResourceResponse(
        error="error preparing devices for claim uid-b: not allocatable")
    mine.claims["uid-a"] = dra.NodePrepareResourceResponse(devices=[
        dra.Device(request_names=("req-0",), pool_name="node-a",
                   device_name="tpu-0",
                   cdi_device_ids=("k8s.tpu.google.com/chip=tpu-0",))])
    theirs = ref_dra.NodePrepareResourcesResponse()
    theirs.claims["uid-a"].devices.add(
        request_names=["req-0"], pool_name="node-a", device_name="tpu-0",
        cdi_device_ids=["k8s.tpu.google.com/chip=tpu-0"])
    theirs.claims["uid-b"].error = mine.claims["uid-b"].error
    assert mine.SerializeToString() == theirs.SerializeToString(
        deterministic=True)
    un = dra.NodeUnprepareResourcesResponse(
        claims={"uid-a": dra.NodeUnprepareResourceResponse()})
    ref_un = ref_dra.NodeUnprepareResourcesResponse()
    ref_un.claims["uid-a"].CopyFrom(ref_dra.NodeUnprepareResourceResponse())
    assert un.SerializeToString() == ref_un.SerializeToString(
        deterministic=True) == b"\n\x09\n\x05uid-a\x12\x00"
    info = reg.PluginInfo(type="DRAPlugin", name="tpu.google.com",
                          endpoint="/p/dra.sock",
                          supported_versions=["v1beta1.DRAPlugin", "1.0.0"])
    assert info.SerializeToString() == ref_reg.PluginInfo(
        type="DRAPlugin", name="tpu.google.com", endpoint="/p/dra.sock",
        supported_versions=["v1beta1.DRAPlugin", "1.0.0"],
    ).SerializeToString(deterministic=True)


def known(msg):
    """``msg`` without the unknown fields protobuf keeps aside."""
    msg.DiscardUnknownFields()
    return msg


UNKNOWN = [
    b"\x78\x96\x01",                      # field 15, varint 150
    b"\x81\x01" + bytes(8),               # field 16, fixed64
    b"\x8a\x01\x03abc",                   # field 17, length-delimited
    b"\x95\x01" + bytes(4),               # field 18, fixed32
]


@pytest.mark.parametrize("port_cls,ref_cls", MESSAGES,
                         ids=[c.__name__ for c, _ in MESSAGES])
def test_unknown_fields_are_skipped(port_cls, ref_cls):
    rng = random.Random(f"unknown-{port_cls.__name__}")
    fields = random_fields(port_cls, rng)
    mine = port_message(port_cls, fields)
    data = mine.SerializeToString()
    theirs = fill_ref(ref_cls(), port_cls, fields)
    for extra in UNKNOWN:
        for mixed in (extra + data, data + extra):
            assert port_cls.FromString(mixed) == mine
            assert known(ref_cls.FromString(mixed)) == theirs
    # A known field number met with another wire type is skipped too.
    for f in port_cls.FIELDS:
        wrong = 0 if f.kind != wire.BOOL else 2
        tag = bytes([f.number << 3 | wrong])
        junk = tag + (b"\x01" if wrong == 0 else b"\x01x")
        assert port_cls.FromString(junk + data) == mine
        assert known(ref_cls.FromString(junk + data)) == theirs


@pytest.mark.parametrize("data", [
    b"\x0a\x05abc",                       # length past the end
    b"\x0a",                              # truncated length
    b"\x0a\x02\xff\xfe",                  # invalid UTF-8 in a string
    b"\x0b",                              # a group (wire type 3)
])
def test_malformed_bytes_raise_on_both(data):
    with pytest.raises(wire.DecodeError):
        dra.Claim.FromString(data)
    with pytest.raises(Exception):
        ref_dra.Claim.FromString(data)


def test_encoder_refuses_wrong_types():
    with pytest.raises(TypeError):
        dra.Claim(uid=7).SerializeToString()
    with pytest.raises(TypeError):
        reg.RegistrationStatus(plugin_registered="yes").SerializeToString()
    with pytest.raises(TypeError):
        dra.NodePrepareResourcesRequest(
            claims=[dra.Device()]).SerializeToString()
