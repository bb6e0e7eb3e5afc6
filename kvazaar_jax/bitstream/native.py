"""ctypes bridge to the native CABAC slice-data serializer
(native/hevc_cabac.cpp).

The Python serializer (bitstream/syntax.py) is the tested oracle; this
module is the production path.  Byte-identical output is enforced by
tests/test_native_cabac.py.  The shared library is built with g++ on
first use into native/build/, under a file name keyed by a hash of the
source and the compile command, so an edited source or changed flags
always rebuild and a stale library is never loaded.  A library that
cannot be built or loaded raises: the encoder never falls back to the
Python serializer on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE_DIR, "hevc_cabac.cpp")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
# Portable flags: the build directory may be copied to another host.
_CXX = ["g++", "-O3", "-shared", "-fPIC", "-pthread"]

_lib = None


def lib_path(src: str = _SRC, build_dir: str = _BUILD_DIR,
             cmd=tuple(_CXX)) -> str:
    """Library file for this source text and compile command."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(cmd).encode())
    return os.path.join(build_dir,
                        f"libhevc_cabac-{h.hexdigest()[:16]}.so")


def build(src: str = _SRC, build_dir: str = _BUILD_DIR,
          cmd=tuple(_CXX)) -> str:
    """Compile `src` unless its hash-keyed library exists; returns the
    library path.  Concurrent builders (test workers) each write a
    private temp file and rename it into place."""
    out = lib_path(src, build_dir, cmd)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(list(cmd) + ["-o", tmp, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"native CABAC build failed ({' '.join(cmd)}):\n"
            f"{r.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.ktpu_encode_slice_data.restype = ctypes.c_int64
    lib.ktpu_encode_slice_data.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ktpu_encode_slice_data_wpp.restype = ctypes.c_int64
    lib.ktpu_encode_slice_data_wpp.argtypes = \
        lib.ktpu_encode_slice_data.argtypes[:-4] + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ktpu_assemble_plane_i8.restype = None
    lib.ktpu_assemble_plane_i8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def _frame_args(params, fd):
    depth8 = np.ascontiguousarray(fd.depth8, np.uint8)
    mode4 = np.ascontiguousarray(fd.mode4, np.uint8)
    cy = np.ascontiguousarray(fd.coeff_y, np.int32)
    chroma = 1 if params.chroma_format_idc else 0
    if chroma:
        ccb = np.ascontiguousarray(fd.coeff_cb, np.int32)
        ccr = np.ascontiguousarray(fd.coeff_cr, np.int32)
    else:
        ccb = ccr = None
    cmode4 = None
    if fd.cmode4 is not None and (fd.cmode4 != 255).any():
        cmode4 = np.ascontiguousarray(fd.cmode4, np.uint8)
    # Hold references so buffers outlive the call.
    return depth8, mode4, cy, ccb, ccr, chroma, cmode4


def _sao_blob(params, fd):
    """Pack FrameData SAO fields into the native per-CTU 20-byte
    layout; None when SAO is disabled."""
    if not params.sao_enabled:
        return None
    cy, cx = fd.sao_merge.shape
    blob = np.zeros((cy * cx, 20), np.int8)
    blob[:, 0] = fd.sao_merge.reshape(-1)
    blob[:, 1:3] = fd.sao_type.reshape(-1, 2)
    blob[:, 3:5] = fd.sao_eo.reshape(-1, 2)
    blob[:, 5:8] = fd.sao_bp.reshape(-1, 3)
    blob[:, 8:20] = fd.sao_off.reshape(-1, 12)
    return np.ascontiguousarray(blob)


def _qp_ctu_arr(params, fd):
    """Writable per-CTU QP buffer for the native serializer (it
    normalizes to effective QPs in place, like the Python one), or
    None when cu_qp_delta is off."""
    if not getattr(params, "cu_qp_delta", False) or fd.qp_ctu is None:
        return None
    return np.ascontiguousarray(fd.qp_ctu, np.int32)


def encode_slice_data_native(params, fd, qp: int) -> bytes:
    """Native equivalent of SliceDataEncoder.encode_slice_data + final
    alignment; returns the CABAC slice-data bytes."""
    lib = get_lib()
    depth8, mode4, cy, ccb, ccr, chroma, cmode4 = _frame_args(params,
                                                               fd)
    cap = cy.nbytes * 2 + 65536
    out = np.empty(cap, np.uint8)
    sao = _sao_blob(params, fd)
    qpc = _qp_ctu_arr(params, fd)
    n = lib.ktpu_encode_slice_data(
        params.width, params.height, chroma, qp,
        params.log2_ctu, params.log2_min_cu, params.log2_max_tu,
        depth8.ctypes.data, mode4.ctypes.data, cy.ctypes.data,
        None if ccb is None else ccb.ctypes.data,
        None if ccr is None else ccr.ctypes.data,
        out.ctypes.data, cap, 1 if params.sign_hiding else 0,
        None if sao is None else sao.ctypes.data,
        None if qpc is None else qpc.ctypes.data,
        None if cmode4 is None else cmode4.ctypes.data)
    if n < 0:
        raise RuntimeError("native slice buffer overflow")
    if qpc is not None:
        fd.qp_ctu[:] = qpc
    return out[:n].tobytes()


def assemble_plane_i8(blocks, bx: int, by: int, s: int, w: int,
                      h: int) -> np.ndarray:
    """(By*Bx, s, s) int8 raster blocks -> (h, w) int32 plane via the
    native widening copy (GIL released; much faster than the numpy
    gather + astype)."""
    lib = get_lib()
    blocks = np.ascontiguousarray(blocks, np.int8)
    plane = np.empty((h, w), np.int32)
    lib.ktpu_assemble_plane_i8(blocks.ctypes.data, bx, by, s,
                               plane.ctypes.data, w, h)
    return plane


def encode_slice_data_native_wpp(params, fd, qp: int,
                                 nthreads: int = 1):
    """WPP variant: returns (bytes, per-substream byte sizes).
    nthreads > 1 row-parallelizes the CABAC substreams (the
    reference's WPP thread parallelism, src/encoderstate.c:776-830,
    applied to the host finalize stage)."""
    lib = get_lib()
    depth8, mode4, cy, ccb, ccr, chroma, cmode4 = _frame_args(params,
                                                               fd)
    cap = cy.nbytes * 2 + 65536
    out = np.empty(cap, np.uint8)
    rows = params.height_in_ctus
    sizes = np.zeros(rows + 1, np.int64)
    nss = np.zeros(1, np.int32)
    sao = _sao_blob(params, fd)
    n = lib.ktpu_encode_slice_data_wpp(
        params.width, params.height, chroma, qp,
        params.log2_ctu, params.log2_min_cu, params.log2_max_tu,
        depth8.ctypes.data, mode4.ctypes.data, cy.ctypes.data,
        None if ccb is None else ccb.ctypes.data,
        None if ccr is None else ccr.ctypes.data,
        out.ctypes.data, cap, sizes.ctypes.data, nss.ctypes.data,
        (1 if params.sign_hiding else 0) | (int(nthreads) << 8),
        None if sao is None else sao.ctypes.data,
        None if (qpc := _qp_ctu_arr(params, fd)) is None
        else qpc.ctypes.data,
        None if cmode4 is None else cmode4.ctypes.data)
    if n < 0:
        raise RuntimeError("native slice buffer overflow")
    if qpc is not None:
        fd.qp_ctu[:] = qpc
    return out[:n].tobytes(), [int(v) for v in sizes[:int(nss[0])]]


def encode_slice_data_native_p(params, fd, qp: int, wpp: bool,
                               slice_type: int = 1,
                               nthreads: int = 1, nref_l0: int = 1):
    """P/B-slice native serializer.  Returns (bytes, sizes) — sizes
    empty when wpp is off."""
    import ctypes
    lib = get_lib()
    if not hasattr(lib, "_p_configured"):
        lib.ktpu_encode_slice_data_p.restype = ctypes.c_int64
        lib.ktpu_encode_slice_data_p.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib._p_configured = True
    depth8, mode4, cy, ccb, ccr, chroma, cmode4 = _frame_args(params,
                                                              fd)
    inter8 = np.ascontiguousarray(fd.inter8, np.uint8)
    skip8 = np.ascontiguousarray(fd.skip8, np.uint8)
    merge8 = np.ascontiguousarray(fd.merge8, np.int8)
    mvp8 = np.ascontiguousarray(fd.mvp8, np.uint8)
    mvd8 = np.ascontiguousarray(fd.mvd8, np.int32)
    cap = cy.nbytes * 2 + 65536
    out = np.empty(cap, np.uint8)
    rows = params.height_in_ctus
    sizes = np.zeros(rows + 1, np.int64)
    nss = np.zeros(1, np.int32)
    dir8 = np.ascontiguousarray(
        fd.dir8 if fd.dir8 is not None else np.zeros_like(fd.inter8),
        np.uint8)
    mvp8_l1 = np.ascontiguousarray(
        fd.mvp8_l1 if fd.mvp8_l1 is not None
        else np.zeros_like(fd.mvp8), np.uint8)
    mvd8_l1 = np.ascontiguousarray(
        fd.mvd8_l1 if fd.mvd8_l1 is not None
        else np.zeros_like(fd.mvd8), np.int32)
    n = lib.ktpu_encode_slice_data_p(
        params.width, params.height, chroma, qp, 1 if wpp else 0,
        slice_type,
        params.log2_ctu, params.log2_min_cu, params.log2_max_tu,
        depth8.ctypes.data, mode4.ctypes.data, cy.ctypes.data,
        None if ccb is None else ccb.ctypes.data,
        None if ccr is None else ccr.ctypes.data,
        inter8.ctypes.data, skip8.ctypes.data, merge8.ctypes.data,
        mvp8.ctypes.data, mvd8.ctypes.data,
        dir8.ctypes.data, mvp8_l1.ctypes.data, mvd8_l1.ctypes.data,
        out.ctypes.data, cap, sizes.ctypes.data, nss.ctypes.data,
        (1 if params.sign_hiding else 0) | (int(nthreads) << 8),
        None if (sao := _sao_blob(params, fd)) is None
        else sao.ctypes.data,
        None if (ref8 := (np.ascontiguousarray(fd.ref8, np.uint8)
                          if fd.ref8 is not None and nref_l0 > 1
                          else None)) is None else ref8.ctypes.data,
        int(nref_l0),
        None if (part8 := (np.ascontiguousarray(fd.part8, np.uint8)
                           if fd.part8 is not None else None)) is None
        else part8.ctypes.data,
        1 if getattr(params, "amp", False) else 0,
        None if (qpc := _qp_ctu_arr(params, fd)) is None
        else qpc.ctypes.data,
        None if cmode4 is None else cmode4.ctypes.data)
    if n < 0:
        raise RuntimeError("native slice buffer overflow")
    if qpc is not None:
        fd.qp_ctu[:] = qpc
    szs = [int(v) for v in sizes[:int(nss[0])]] if wpp else []
    return out[:n].tobytes(), szs
