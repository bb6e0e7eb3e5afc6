"""Bit I/O and CABAC engine tests.

The key invariant (the analogue of the reference's cross-backend kernel
equivalence tests, tests/test_strategies.c): encoder and decoder are exact
inverses for arbitrary bin sequences, context-coded and bypass, including
terminate/flush, through emulation prevention and NAL framing.
"""

import random

import pytest

from kvazaar_jax.bitstream.bits import (
    BitReader, BitWriter, emulation_prevention, nal_unit, split_annexb,
    strip_emulation_prevention)
from kvazaar_jax.bitstream.cabac import CabacDecoder, CabacEncoder
from kvazaar_jax.bitstream.contexts import Contexts
from kvazaar_jax.constants import SLICE_I

pytestmark = pytest.mark.smoke


def test_bitwriter_ue_se_roundtrip():
    w = BitWriter()
    values = list(range(40)) + [255, 1023, 65535]
    for v in values:
        w.ue(v)
    svalues = [0, 1, -1, 2, -2, 17, -31, 255, -255]
    for v in svalues:
        w.se(v)
    w.rbsp_trailing_bits()
    r = BitReader(w.get_bytes())
    assert [r.ue() for _ in values] == values
    assert [r.se() for _ in svalues] == svalues
    assert r.bit() == 1


def test_emulation_prevention_roundtrip():
    rng = random.Random(0)
    for _ in range(50):
        raw = bytes(rng.choice([0, 0, 0, 1, 2, 3, 255])
                    for _ in range(rng.randint(0, 64)))
        ep = emulation_prevention(raw)
        # No start-code-like pattern survives (00 00 03 is the escape
        # itself and is legal).
        for i in range(len(ep) - 2):
            assert not (ep[i] == 0 and ep[i + 1] == 0 and ep[i + 2] <= 2)
        assert strip_emulation_prevention(ep) == raw


def test_nal_framing_roundtrip():
    # Valid RBSPs always end with a nonzero byte (rbsp_stop_one_bit).
    payloads = [b"\x00\x00\x00\x80", b"hello", b"\x00\x00\x01\x02\x03"]
    stream = b"".join(nal_unit(p, nal_type=t, long_start_code=(i == 0))
                      for i, (t, p) in enumerate(zip([32, 33, 1], payloads)))
    out = list(split_annexb(stream))
    assert [t for t, _, _ in out] == [32, 33, 1]
    assert [p for _, _, p in out] == payloads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cabac_roundtrip(seed):
    rng = random.Random(seed)
    n = 2000
    # Mix of context-coded bins (across several contexts), bypass bins,
    # and mid-stream zero terminates.
    plan = []
    for _ in range(n):
        kind = rng.random()
        if kind < 0.6:
            plan.append(("ctx", rng.randrange(3), rng.randrange(2)))
        elif kind < 0.9:
            plan.append(("bypass", None, rng.randrange(2)))
        else:
            plan.append(("term", None, 0))
    plan.append(("term", None, 1))

    w = BitWriter()
    enc = CabacEncoder(w)
    ctxs = Contexts(SLICE_I, qp=27)
    for kind, idx, val in plan:
        if kind == "ctx":
            enc.encode_bin(ctxs("split_flag", idx), val)
        elif kind == "bypass":
            enc.encode_bypass(val)
        else:
            enc.encode_terminate(val)
    w.align_zero()
    data = w.get_bytes()

    r = BitReader(data)
    dec = CabacDecoder(r)
    ctxs2 = Contexts(SLICE_I, qp=27)
    for kind, idx, val in plan:
        if kind == "ctx":
            got = dec.decode_bin(ctxs2("split_flag", idx))
        elif kind == "bypass":
            got = dec.decode_bypass()
        else:
            got = dec.decode_terminate()
        assert got == val


def test_cabac_bypass_heavy_roundtrip():
    rng = random.Random(7)
    vals = [rng.randrange(1 << 16) for _ in range(200)]
    w = BitWriter()
    enc = CabacEncoder(w)
    for v in vals:
        enc.encode_bypass_bins(v, 16)
    enc.encode_terminate(1)
    w.align_zero()
    r = BitReader(w.get_bytes())
    dec = CabacDecoder(r)
    assert [dec.decode_bypass_bins(16) for _ in vals] == vals
    assert dec.decode_terminate() == 1


def test_context_states_track_between_enc_dec():
    # After coding the same bins, encoder-side and decoder-side context
    # states must be identical (required for WPP context inheritance).
    rng = random.Random(3)
    bins = [rng.randrange(2) for _ in range(500)]
    w = BitWriter()
    enc = CabacEncoder(w)
    c1 = Contexts(SLICE_I, qp=32)
    for b in bins:
        enc.encode_bin(c1("sig", 5), b)
    enc.encode_terminate(1)
    w.align_zero()
    dec = CabacDecoder(BitReader(w.get_bytes()))
    c2 = Contexts(SLICE_I, qp=32)
    for _ in bins:
        dec.decode_bin(c2("sig", 5))
    assert (c1("sig", 5).state, c1("sig", 5).mps) == \
           (c2("sig", 5).state, c2("sig", 5).mps)
