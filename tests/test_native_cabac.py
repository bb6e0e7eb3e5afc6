"""Native (C++) slice serializer must be byte-identical to the Python
oracle — this encoder's analogue of the reference's generic-vs-SIMD
strategy equivalence tests (tests/test_strategies.c)."""

import numpy as np
import pytest

from kvazaar_jax.bitstream import native
from kvazaar_jax.bitstream.bits import BitWriter
from kvazaar_jax.bitstream.cabac import CabacEncoder
from kvazaar_jax.bitstream.contexts import Contexts
from kvazaar_jax.bitstream.headers import StreamParams
from kvazaar_jax.bitstream.syntax import SliceDataEncoder
from kvazaar_jax.constants import SLICE_I

from tests.test_syntax import random_frame_data

pytestmark = pytest.mark.smoke


def python_slice_bytes(params, fd, qp):
    w = BitWriter()
    enc = SliceDataEncoder(params, fd, Contexts(SLICE_I, qp),
                           CabacEncoder(w))
    enc.encode_slice_data()
    w.align_zero()
    return w.get_bytes()


@pytest.mark.parametrize("width,height,chroma,seed,qp", [
    (64, 64, True, 0, 27),
    (128, 64, True, 1, 22),
    (64, 64, False, 2, 37),
    (192, 128, True, 3, 32),
    (80, 48, True, 4, 17),
    (104, 72, True, 5, 45),
])
def test_native_matches_python(width, height, chroma, seed, qp):
    rng = np.random.default_rng(seed)
    params = StreamParams(width=width, height=height, qp=qp,
                          chroma_format_idc=1 if chroma else 0)
    fd = random_frame_data(rng, width, height, chroma)
    py = python_slice_bytes(params, fd, qp)
    nat = native.encode_slice_data_native(params, fd, qp)
    assert nat == py


def test_native_zero_frame():
    from kvazaar_jax.bitstream.syntax import FrameData
    params = StreamParams(width=128, height=64, qp=22)
    fd = FrameData.empty(128, 64)
    fd.depth8[:] = 2
    fd.mode4[:] = 26
    assert native.encode_slice_data_native(params, fd, 22) == \
        python_slice_bytes(params, fd, 22)


def python_slice_bytes_wpp(params, fd, qp):
    w = BitWriter()
    enc = SliceDataEncoder(params, fd, Contexts(SLICE_I, qp),
                           CabacEncoder(w))
    sizes = enc.encode_slice_data_wpp()
    return w.get_bytes(), sizes


@pytest.mark.parametrize("width,height,seed,qp", [
    (192, 128, 7, 27), (128, 256, 8, 35), (64, 64, 9, 22),
])
def test_native_wpp_matches_python(width, height, seed, qp):
    from kvazaar_jax.bitstream import native as nat
    rng = np.random.default_rng(seed)
    params = StreamParams(width=width, height=height, qp=qp, wpp=True)
    fd = random_frame_data(rng, width, height, True)
    py, py_sizes = python_slice_bytes_wpp(params, fd, qp)
    nb, nb_sizes = nat.encode_slice_data_native_wpp(params, fd, qp)
    assert nb_sizes == py_sizes
    assert nb == py


@pytest.mark.parametrize("width,height,seed,qp,wpp", [
    (128, 128, 20, 30, False), (192, 128, 21, 27, True),
    (64, 64, 22, 40, False),
])
def test_native_p_matches_python(width, height, seed, qp, wpp):
    from kvazaar_jax.bitstream import native as nat
    from kvazaar_jax.constants import SLICE_P
    from tests.test_syntax import random_p_frame_data
    rng = np.random.default_rng(seed)
    params = StreamParams(width=width, height=height, qp=qp, wpp=wpp)
    fd = random_p_frame_data(rng, width, height, True)
    w = BitWriter()
    enc = SliceDataEncoder(params, fd, Contexts(SLICE_P, qp),
                           CabacEncoder(w))
    if wpp:
        py_sizes = enc.encode_slice_data_wpp()
    else:
        enc.encode_slice_data()
        w.align_zero()
        py_sizes = []
    py = w.get_bytes()
    nb, nb_sizes = nat.encode_slice_data_native_p(params, fd, qp, wpp)
    assert nb_sizes == py_sizes
    assert nb == py


@pytest.mark.parametrize("nthreads", [2, 4])
def test_native_wpp_parallel_byte_identical(nthreads):
    """Row-parallel CABAC (2-CTU-lag context stagger across worker
    threads) must be byte-identical to the sequential encode."""
    from kvazaar_jax.bitstream import native as nat
    from tests.test_syntax import random_p_frame_data
    rng = np.random.default_rng(33)
    params = StreamParams(width=320, height=256, qp=30, wpp=True)
    fd = random_p_frame_data(rng, 320, 256, True)
    seq, seq_sizes = nat.encode_slice_data_native_p(params, fd, 30,
                                                    True)
    par, par_sizes = nat.encode_slice_data_native_p(
        params, fd, 30, True, nthreads=nthreads)
    assert par_sizes == seq_sizes
    assert par == seq


def test_native_assemble_plane_i8():
    from kvazaar_jax.bitstream import native as nat
    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.intra_recon import blocks_to_plane
    rng = np.random.default_rng(7)
    plan = make_intra_plan(96, 64, 16, chroma=False)
    blocks = rng.integers(-127, 128,
                          (plan.blocks_y * plan.blocks_x, 16, 16)
                          ).astype(np.int8)
    got = nat.assemble_plane_i8(blocks, plan.blocks_x, plan.blocks_y,
                                16, 96, 64)
    g = blocks.reshape(plan.blocks_y, plan.blocks_x, 16, 16)
    ref = g.transpose(0, 2, 1, 3).reshape(64, 96).astype(np.int32)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("nref", [2, 4])
def test_native_p_multiref_matches_python(nref):
    """Multi-ref P: native ref_idx coding must be byte-identical to
    the Python serializer."""
    from kvazaar_jax.bitstream import native as nat
    from kvazaar_jax.bitstream.bits import BitWriter
    from kvazaar_jax.bitstream.cabac import CabacEncoder
    from kvazaar_jax.bitstream.contexts import Contexts
    from kvazaar_jax.bitstream.syntax import SliceDataEncoder
    from kvazaar_jax.constants import SLICE_P
    from tests.test_syntax import random_p_frame_data
    rng = np.random.default_rng(40 + nref)
    W, H = 192, 128
    params = StreamParams(width=W, height=H, qp=30, wpp=True)
    fd = random_p_frame_data(rng, W, H, True)
    fd.ref8[:] = rng.integers(0, nref, fd.ref8.shape).astype(np.uint8)
    w = BitWriter()
    enc = SliceDataEncoder(params, fd, Contexts(SLICE_P, 30),
                           CabacEncoder(w), nref_l0=nref)
    py_sizes = enc.encode_slice_data_wpp()
    py = w.get_bytes()
    nb, nb_sizes = nat.encode_slice_data_native_p(
        params, fd, 30, True, nref_l0=nref)
    assert nb_sizes == py_sizes
    assert nb == py


def test_native_dqp_matches_python():
    """cu_qp_delta: native serializer byte-identical to Python and
    identical effective-QP normalization."""
    from kvazaar_jax.bitstream import native as nat
    from kvazaar_jax.bitstream.bits import BitWriter
    from kvazaar_jax.bitstream.cabac import CabacEncoder
    from kvazaar_jax.bitstream.contexts import Contexts
    from kvazaar_jax.bitstream.syntax import SliceDataEncoder
    from kvazaar_jax.constants import SLICE_I
    from tests.test_syntax import random_frame_data
    rng = np.random.default_rng(51)
    W, H = 192, 128
    for wpp in (False, True):
        params = StreamParams(width=W, height=H, qp=30,
                              chroma_format_idc=1, cu_qp_delta=True,
                              wpp=wpp)
        fd = random_frame_data(rng, W, H, True)
        fd.coeff_y[64:128, 0:64] = 0     # one CTU without coefficients
        fd.coeff_cb[32:64, 0:32] = 0
        fd.coeff_cr[32:64, 0:32] = 0
        cy, cx = -(-H // 64), -(-W // 64)
        fd.qp_ctu = (30 + rng.integers(-5, 6, (cy, cx))).astype(np.int32)
        import copy
        fd2 = copy.deepcopy(fd)
        w = BitWriter()
        enc = SliceDataEncoder(params, fd, Contexts(SLICE_I, 30),
                               CabacEncoder(w))
        if wpp:
            sizes_py = enc.encode_slice_data_wpp()
        else:
            enc.encode_slice_data()
            w.align_zero()
            sizes_py = []
        py = w.get_bytes()
        if wpp:
            nb, sizes_n = nat.encode_slice_data_native_wpp(params, fd2,
                                                           30)
            assert sizes_n == sizes_py
        else:
            nb = nat.encode_slice_data_native(params, fd2, 30)
        assert nb == py
        np.testing.assert_array_equal(fd2.qp_ctu, fd.qp_ctu)


def test_native_smp_amp_matches_python():
    from kvazaar_jax.bitstream import native as nat
    from kvazaar_jax.bitstream.bits import BitWriter
    from kvazaar_jax.bitstream.cabac import CabacEncoder
    from kvazaar_jax.bitstream.contexts import Contexts
    from kvazaar_jax.bitstream.syntax import SliceDataEncoder
    from kvazaar_jax.constants import SLICE_P
    from tests.test_syntax import random_p_frame_data
    rng = np.random.default_rng(52)
    W, H = 192, 128
    for amp in (False, True):
        params = StreamParams(width=W, height=H, qp=30, wpp=True,
                              amp=amp)
        fd = random_p_frame_data(rng, W, H, True)
        g8 = fd.depth8.shape
        seen = np.zeros(g8, bool)
        parts = (1, 2, 4, 5, 6, 7) if amp else (1, 2)
        for c8y in range(g8[0]):
            for c8x in range(g8[1]):
                if seen[c8y, c8x]:
                    continue
                size = 64 >> int(fd.depth8[c8y, c8x])
                cells = max(size >> 3, 1)
                seen[c8y:c8y + cells, c8x:c8x + cells] = True
                ok_amp = size == 32
                cand = [p_ for p_ in parts if p_ < 4 or ok_amp]
                if (fd.inter8[c8y, c8x] and not fd.skip8[c8y, c8x]
                        and size >= 16 and rng.random() < 0.6):
                    part = int(rng.choice(cand))
                    fd.part8[c8y, c8x] = part
                    from kvazaar_jax.encoder.inter_cands import \
                        pu_cell_rects
                    (ry, rx, _h, _w) = pu_cell_rects(
                        c8y, c8x, cells, part)[1]
                    if rng.random() < 0.5:
                        fd.merge8[ry, rx] = int(rng.integers(0, 5))
                    else:
                        fd.merge8[ry, rx] = -1
                        fd.mvd8[ry, rx] = rng.integers(-30, 30, 2)
                        fd.mvp8[ry, rx] = int(rng.integers(0, 2))
        w = BitWriter()
        enc = SliceDataEncoder(params, fd, Contexts(SLICE_P, 30),
                               CabacEncoder(w))
        sizes_py = enc.encode_slice_data_wpp()
        py = w.get_bytes()
        nb, sizes_n = nat.encode_slice_data_native_p(params, fd, 30,
                                                     True)
        assert sizes_n == sizes_py
        assert nb == py, f"amp={amp}"
