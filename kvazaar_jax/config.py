"""Encoder configuration.

The reference drives everything through a single string-keyed config struct
(kvz_config, src/kvazaar.h:240-398; parser src/cfg.c:358) with presets that
replay option lists through the parser (src/cfg.c:386).  We mirror that
shape: a dataclass of options, a `set(key, value)` string parser, and preset
tables; validation happens in `validate()` (the analogue of
kvz_encoder_control_init's checks, src/encoder.c:206).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # Source format.
    width: int = 0
    height: int = 0
    input_bitdepth: int = 8
    framerate_num: int = 25
    framerate_denom: int = 1
    chroma_format: int = 420  # 400 or 420 (reference: KVZ_CSP_400/420)

    # Coding structure.
    qp: int = 22
    intra_period: int = 64     # 0 = only first frame intra; 1 = all intra
    gop_len: int = 0           # 0 = IPPP low-delay, 4/8 = B-pyramid (later)
    open_gop: bool = True      # CRA anchors for periodic intra in GOPs
    #                            (reference default, src/cfg.c:120)
    ref_frames: int = 1
    # Low-delay GOP structure "lp-g#d#t#" (reference --gop lp-...,
    # src/cfg.c:885): (g, d, t) or None.  Implies gop_len 0 semantics
    # with per-position QP offsets and multi-ref lists.
    lp_gop: Optional[tuple] = None

    # Coding tools (subset grows toward the reference's kvz_config).
    deblock: bool = True
    sao: bool = False          # sample-adaptive offset (8.7.3)
    rdoq: bool = False
    signhide: bool = False
    transform_skip: bool = False
    lossless: bool = False
    # Implicit residual DPCM for hor/ver intra TBs under transquant
    # bypass (reference --implicit-rdpcm, src/transform.c:362).
    implicit_rdpcm: bool = False
    rd: int = 1                # RDO depth (0 = pure-SATD mode argmin,
                               # 1 = +MPM-aware bit re-rank), like --rd
    # Explicit intra TU-split search depth (--tr-depth-intra,
    # reference src/cfg.c:721 + search_intra_trdepth
    # src/search_intra.c:189).  1 = each 16/32 intra CU may code one
    # split_transform_flag level (four half-size TBs, RD-chosen).
    tr_depth_intra: int = 0

    # Partitioning (device-friendly knobs; see encoder/frame_encoder.py).
    # pu_depth ranges as in the reference's --pu-depth-intra/inter.
    # inter 0 = follow the intra range (resolved in validate()); P/B
    # frames run the variable quadtree when either range is
    # non-degenerate (single-ref-per-list structures; multi-ref/TMVP/
    # SMP inter frames keep a fixed grid — documented degradation).
    intra_min_cu: int = 32
    intra_max_cu: int = 32
    inter_min_cu: int = 0
    inter_max_cu: int = 0

    # Motion estimation.
    me_range: int = 16         # full-search window radius (exhaustive)
    me_subpel: bool = True
    # SMP inter partitions (PART_2NxN / PART_Nx2N; reference --smp,
    # kvz_search_cu_smp src/search_inter.c:1627).  P slices, one ref.
    smp: bool = False
    # AMP (asymmetric) partitions 2NxnU/2NxnD/nLx2N/nRx2N (reference
    # --amp); needs smp and 32x32 CUs (quarter splits at the 8-cell
    # granularity).
    amp: bool = False

    # Selective encryption (reference --crypto): hex key or
    # passphrase; AES-CTR keystream XORed into sign bypass bins with a
    # per-picture nonce.
    crypto: Optional[str] = None

    # Bi-prediction in B slices (reference --bipred; we default on —
    # the exhaustive search absorbs the cost the reference avoids).
    bipred: bool = True
    # Integer search algorithm (reference --me hexbs/tz/full/dia/
    # fullN).  The device search is always the exhaustive dense surface (a
    # capability superset of every pattern search at equal-or-better
    # quality); names are accepted and recorded for preset parity.
    me: str = "full"
    # Temporal MVP (sps_temporal_mvp_enabled_flag; reference --mv-constraint
    # era default on).  Implemented for low-delay P slices.
    tmvp: bool = False

    # Rate control (0 = fixed QP).
    bitrate: int = 0
    # LCU-level rate control: per-CTU bit allocation + QP via
    # cu_qp_delta (reference lcu_allocate_bits src/rate_control.c:259,
    # kvz_set_lcu_lambda_and_qp :278).  Applies when bitrate > 0.
    lcu_rc: bool = True
    # Delta-QP ROI map file: "W H" header then W*H integer QP offsets
    # on a CTU grid, scaled to the frame (reference --roi,
    # src/cfg.c ROI parsing + src/encoder.c:127-170).
    roi: Optional[str] = None
    # Adaptive quantization strength (variance AQ at CTU granularity);
    # 0 = off.
    aq: float = 0.0

    # Decoded-picture-hash SEI per frame ("none", "md5", "checksum";
    # reference --hash).
    hash: str = "none"

    # Scaling lists (quantization matrices): "off" (flat), "default"
    # (spec default lists), "custom" (HM-format cqmfile, reference
    # --cqmfile, src/scalinglist.c:130).
    scaling_list: str = "off"
    cqmfile: Optional[str] = None

    # VUI signalling (reference --sar/--overscan/--videoformat/--range/
    # --colorprim/--transfer/--colormatrix/--chromaloc, src/cfg.c) +
    # access-unit delimiters (--aud) + version SEI (--(no-)info).
    sar_width: int = 0
    sar_height: int = 0
    overscan: int = 0            # 0 undef, 1 show, 2 crop
    videoformat: int = 5
    fullrange: int = 0
    colorprim: int = 2
    transfer: int = 2
    colormatrix: int = 2
    chromaloc: int = 0
    aud: bool = False
    # Re-emit VPS/SPS/PPS before every Nth IRAP (reference
    # --vps-period, src/encoder_state-bitstream.c:982-1010 assembly;
    # 0 = parameter sets once at stream start, N>=1 = every Nth IRAP).
    vps_period: int = 0
    info: bool = True

    # Tiles (reference --tiles WxH, uniform spacing; src/cfg.c tiles
    # parsing + src/encoder.c:387-520 geometry).  Breaks prediction
    # and entropy dependencies at tile boundaries: independent CABAC
    # substreams with entry points, shorter wavefront schedules, and
    # the unit of within-frame multi-chip sharding.
    tiles_x: int = 1
    tiles_y: int = 1

    # --slices: "none", "wpp" (each CTU row a dependent slice
    # segment), "tiles" (independent slice per tile) — reference
    # src/kvazaar.h:198-201 (bitstream-only; scheduling unchanged).
    slices: str = "none"

    # Interlaced source (reference --source-scan-type, src/cfg.c:731 +
    # field adapter src/kvazaar.c:294): 0 progressive, 1 tff, 2 bff.
    # Each input frame codes as two half-height field pictures with
    # field_seq VUI + per-picture pic_timing SEI.
    source_scan_type: int = 0

    # Level/tier (reference --level/--high-tier, src/cfg.c:1460-1540):
    # level None = lowest fitting level (A.4.1); a forced level is
    # validated against the picture-size/sample-rate limits.
    level: Optional[str] = None
    tier: str = "main"         # "main" or "high"

    # Host parallelism knobs (reference --threads/--owf;
    # src/encoder.c:43-51,249-273).  0 = auto.  threads sizes the host
    # CABAC pools; owf the streaming pipeline depth (device dispatch /
    # download / finalize overlap).
    threads: int = 0
    owf: int = 0

    # Parallelism: device mesh shape for within-frame sharding.
    mesh_tiles: int = 1
    # Wavefront parallel processing (entropy_coding_sync): per-CTU-row
    # CABAC substreams, on by default like the reference (src/cfg.c:91).
    wpp: bool = True

    @property
    def cu_qp_delta_active(self) -> bool:
        """True when per-CTU QP signalling will actually be used.

        ROI/AQ force it (validate() rejects unsupported combos for
        those explicit requests).  LCU rate control uses it on the
        structures it supports and documentedly falls back to
        frame-level RC elsewhere (B pyramids, multi-ref, lossless,
        variable trees, tiles) — a degradation, not a silent no-op."""
        if self.roi is not None or self.aq > 0:
            return True
        if not (self.bitrate > 0 and self.lcu_rc):
            return False
        if (self.gop_len > 1 or self.lp_gop is not None
                or self.ref_frames > 1 or self.tmvp):
            return False
        if (self.lossless or self.scaling_list != "off"
                or self.transform_skip):
            return False
        if (self.intra_min_cu != self.intra_max_cu
                or self.inter_min_cu != self.inter_max_cu
                or self.intra_max_cu == 4):
            return False
        if (self.tiles_x, self.tiles_y) != (1, 1):
            return False
        if self.slices != "none" or self.smp:
            return False
        return True

    def validate(self) -> "Config":
        """Reject anything the encoder cannot honor (the analogue of
        kvz_encoder_control_init's checks, src/encoder.c:206): accepted
        means implemented — no silent no-op knobs."""
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be set")
        if self.qp < 0 or self.qp > 51:
            raise ValueError("qp out of [0, 51]")
        if self.input_bitdepth not in (8, 10):
            raise ValueError("bitdepth must be 8 or 10")
        if self.chroma_format not in (400, 420):
            raise ValueError("chroma_format must be 400 or 420")
        for v in (self.intra_min_cu, self.intra_max_cu):
            if v not in (4, 8, 16, 32, 64):
                raise ValueError(
                    "intra cu sizes must be in {4,8,16,32,64}")
        if self.intra_min_cu > self.intra_max_cu:
            raise ValueError("intra_min_cu > intra_max_cu")
        # Inter CU range: 0 = follow intra (clamped to the inter-legal
        # [8, 64]; the reference's --pu-depth-inter semantics).
        if self.inter_min_cu == 0:
            self.inter_min_cu = max(self.intra_min_cu, 8)
        if self.inter_max_cu == 0:
            self.inter_max_cu = max(self.intra_max_cu, 8)
        for v in (self.inter_min_cu, self.inter_max_cu):
            if v not in (8, 16, 32, 64):
                raise ValueError("inter cu sizes must be in "
                                 "{8,16,32,64}")
        if self.inter_min_cu > self.inter_max_cu:
            raise ValueError("inter_min_cu > inter_max_cu")
        # The shared quadtree needs every level of the union range
        # covered by at least one tool.
        lo = min(self.intra_min_cu, self.inter_min_cu)
        hi = max(self.intra_max_cu, self.inter_max_cu)
        s = max(lo, 8)
        while s <= hi:
            if not (self.intra_min_cu <= s <= self.intra_max_cu
                    or self.inter_min_cu <= s <= self.inter_max_cu):
                raise ValueError(
                    f"CU size {s} is in neither the intra nor the "
                    "inter range (the shared quadtree needs "
                    "contiguous coverage)")
            s *= 2
        if self.intra_max_cu == 64 and self.intra_min_cu == 64:
            raise ValueError("64x64 CUs require the variable quadtree "
                             "(intra_min_cu < 64)")
        if self.intra_min_cu == 64:
            raise ValueError("intra_min_cu cannot be 64")
        if 4 in (self.intra_min_cu, self.intra_max_cu):
            # The intra-NxN operating point: 8x8 CUs as four 4x4
            # PUs/TUs (DST-VII).  Fixed-granularity all-intra for now.
            if self.intra_min_cu != 4 or self.intra_max_cu != 4:
                raise ValueError("4x4 intra is a fixed operating point "
                                 "(intra_min_cu=intra_max_cu=4)")
            if self.intra_period != 1:
                raise ValueError("4x4 intra (NxN) requires all-intra "
                                 "coding (--period 1) for now")
            if (self.tiles_x, self.tiles_y) != (1, 1):
                raise ValueError("tiles with 4x4 intra are not "
                                 "implemented")
        if self.transform_skip:
            # TS applies to 4x4 TBs (7.3.8.11); only the intra-NxN
            # operating point produces them today.
            if self.intra_max_cu != 4:
                raise ValueError("transform_skip needs 4x4 TUs: set "
                                 "intra_min_cu=intra_max_cu=4")
            if self.rdoq:
                raise ValueError("transform_skip with RDOQ is not "
                                 "implemented")
            if self.lossless:
                raise ValueError("transform_skip is meaningless with "
                                 "--lossless")
            if self.scaling_list != "off":
                raise ValueError("transform_skip with scaling lists "
                                 "is not implemented")
        if self.tr_depth_intra not in (0, 1):
            raise ValueError("--tr-depth-intra supports 0 or 1 "
                             "(one explicit TU-split level)")
        if self.tr_depth_intra:
            if not (self.intra_min_cu < self.intra_max_cu
                    and self.intra_min_cu >= 8):
                raise ValueError(
                    "--tr-depth-intra needs the variable intra "
                    "quadtree (intra_min_cu < intra_max_cu, min >= 8)")
            if self.lossless:
                raise ValueError("--tr-depth-intra with --lossless is "
                                 "not implemented")
            if self.cu_qp_delta_active:
                raise ValueError("--tr-depth-intra with per-CTU QP "
                                 "(LCU rate control / ROI) is not "
                                 "implemented")
            if self.mesh_tiles > 1:
                raise ValueError("--tr-depth-intra under mesh sharding "
                                 "is not implemented")
        if not 1 <= self.ref_frames <= 4:
            raise ValueError("ref_frames must be in [1, 4]")
        if not 1 <= self.me_range <= 64:
            raise ValueError("me_range must be in [1, 64] (the MC "
                             "phase-plane extension covers 64+tap "
                             "overreach)")
        if self.ref_frames > 1 and self.gop_len > 1:
            raise ValueError("multiple references are implemented for "
                             "low-delay structures only (B pyramids "
                             "use one ref per list)")
        if self.tmvp and self.gop_len > 1:
            raise ValueError("TMVP is implemented for low-delay "
                             "structures only (B slices signal it "
                             "off)")
        if self.lp_gop is not None:
            g, d, t = self.lp_gop
            if not (1 <= g <= 8 and 1 <= d <= 4 and 1 <= t <= 8):
                raise ValueError("lp gop out of range (g 1-8, d 1-4, "
                                 "t 1-8)")
            if self.gop_len > 1:
                raise ValueError("lp gop excludes B-pyramid gop_len")
        if self.gop_len not in (0, 1, 4, 8):
            raise ValueError("gop_len must be 0/1 (low delay) or 4/8 "
                             "(hierarchical B pyramid)")
        if self.intra_period == 1:
            # All-intra coding overrides any GOP structure (the
            # reference's -p 1 makes every picture an IDR regardless
            # of --gop).
            self.gop_len = 0
            self.lp_gop = None
        if self.gop_len > 1 and self.intra_period != 0:
            # Periodic intra inside a B pyramid: open-GOP CRA anchors
            # with RASL leading pictures (the reference defaults
            # open_gop true, src/cfg.c:120; closed periodic GOPs are
            # not implemented).
            if not self.open_gop:
                raise ValueError("periodic intra with --gop requires "
                                 "open GOP (CRA anchors); "
                                 "--period 0 for closed single-IDR "
                                 "streams")
            if self.intra_period % self.gop_len != 0:
                raise ValueError("--period with --gop must be a "
                                 "multiple of the GOP length")
        if self.mesh_tiles != 1:
            # Multi-device end-to-end encode: tile-row bands sharded
            # over a device mesh, one spliced bitstream (all-intra,
            # fixed CU; the band compute is zero-communication, the
            # loop filter halo-exchanges over ICI).
            if not 2 <= self.mesh_tiles <= 16:
                raise ValueError("mesh_tiles must be 1..16")
            if self.intra_period != 1:
                raise ValueError("mesh_tiles requires all-intra coding "
                                 "(--period 1) for now")
            if (self.intra_min_cu != self.intra_max_cu
                    or self.intra_max_cu == 4):
                raise ValueError("mesh_tiles requires a fixed CU size")
            if self.tiles_y not in (1, self.mesh_tiles):
                raise ValueError("tiles_y must equal mesh_tiles (each "
                                 "band is a tile row)")
            self.tiles_y = self.mesh_tiles
            if self.height % (64 * self.mesh_tiles):
                raise ValueError("frame height must split into whole "
                                 "64-pixel CTU-row bands per device")
            for flag, name in ((self.sao, "sao"),
                               (self.bitrate > 0, "rate control"),
                               (self.crypto is not None, "crypto"),
                               (self.lossless, "lossless"),
                               (self.transform_skip, "transform_skip"),
                               (self.scaling_list != "off",
                                "scaling lists"),
                               (self.slices != "none", "slices"),
                               (self.roi is not None or self.aq > 0,
                                "ROI/AQ")):
                if flag:
                    raise ValueError(
                        f"mesh_tiles with {name} is not implemented")
        if not (1 <= self.tiles_x <= 16 and 1 <= self.tiles_y <= 16):
            raise ValueError("tiles must be 1..16 per axis")
        if (self.tiles_x, self.tiles_y) != (1, 1):
            if (self.intra_min_cu != self.intra_max_cu
                    or self.inter_min_cu != self.inter_max_cu):
                raise ValueError("tiles require a fixed CU size for "
                                 "now")
            ctus_x = -(-self.width // 64)
            ctus_y = -(-self.height // 64)
            if self.tiles_x > ctus_x or self.tiles_y > ctus_y:
                raise ValueError("more tiles than CTUs")
        if self.rd > 3:
            raise ValueError("--rd levels above 3 are not implemented")
        if self.rd >= 2 and self.intra_max_cu == 4:
            raise ValueError("--rd 2 with the 4x4 intra operating "
                             "point is not implemented")
        if self.rd >= 3 and self.mesh_tiles != 1:
            # rd 3 adds explicit chroma-mode RDO (the reference's
            # rdo >= 3 chroma search, src/search_intra.c:736); the
            # sharded mesh program doesn't carry it yet.
            raise ValueError("--rd 3 with mesh_tiles is not "
                             "implemented")
        if self.rdoq and self.lossless:
            raise ValueError("RDOQ is meaningless with --lossless")
        if self.implicit_rdpcm:
            # Matches the reference's check (src/cfg.c:1521).
            if not self.lossless:
                raise ValueError("--implicit-rdpcm requires --lossless")
            if self.intra_min_cu != self.intra_max_cu \
                    or self.intra_max_cu == 4:
                raise ValueError("implicit RDPCM with variable trees / "
                                 "4x4 NxN is not implemented yet")
        if self.scaling_list not in ("off", "default", "custom"):
            raise ValueError("scaling_list must be off/default/custom")
        if self.scaling_list == "custom" and not self.cqmfile:
            raise ValueError("custom scaling lists need --cqmfile")
        if self.cqmfile and self.scaling_list != "custom":
            self.scaling_list = "custom"
        if self.scaling_list != "off" and self.lossless:
            raise ValueError("scaling lists are meaningless with "
                             "--lossless")
        if self.sao and self.lossless:
            raise ValueError("SAO is meaningless with --lossless")
        if self.roi is not None or self.aq > 0:
            # Explicit per-CTU QP requests: reject what the traced-QP
            # path cannot honor (LCU RC instead degrades to frame-level
            # RC on these structures — see cu_qp_delta_active).
            if (self.intra_min_cu != self.intra_max_cu
                    or self.inter_min_cu != self.inter_max_cu):
                raise ValueError("ROI/AQ require a fixed CU size for "
                                 "now")
            if self.intra_max_cu == 4:
                raise ValueError("ROI/AQ with the 4x4 intra operating "
                                 "point are not implemented")
            if self.gop_len > 1:
                raise ValueError("ROI/AQ with B pyramids are not "
                                 "implemented (low-delay only)")
            if self.ref_frames > 1 or self.lp_gop is not None \
                    or self.tmvp:
                raise ValueError("ROI/AQ with multi-ref / TMVP "
                                 "structures are not implemented")
            if (self.tiles_x, self.tiles_y) != (1, 1):
                raise ValueError("ROI/AQ with tiles are not "
                                 "implemented")
            if self.lossless:
                raise ValueError("ROI/AQ are meaningless with "
                                 "--lossless")
            if self.scaling_list != "off":
                raise ValueError("ROI/AQ with scaling lists are not "
                                 "implemented")
            if self.transform_skip:
                raise ValueError("ROI/AQ with transform skip are not "
                                 "implemented")
        if self.aq < 0 or self.aq > 3:
            raise ValueError("aq strength must be in [0, 3]")
        if self.smp:
            if self.ref_frames > 1 or self.lp_gop is not None \
                    or self.tmvp:
                raise ValueError("SMP with multi-ref / TMVP is not "
                                 "implemented")
            if self.gop_len > 1:
                raise ValueError("SMP with B pyramids is not "
                                 "implemented (P slices only)")
            if (self.intra_min_cu != self.intra_max_cu
                    or self.inter_min_cu != self.inter_max_cu
                    or self.intra_max_cu < 16):
                raise ValueError("SMP requires a fixed CU size >= 16")
            if (self.tiles_x, self.tiles_y) != (1, 1):
                raise ValueError("SMP with tiles is not implemented")
            if self.roi is not None or self.aq > 0:
                raise ValueError("SMP with ROI/AQ is not implemented")
        if self.amp:
            if not self.smp:
                raise ValueError("--amp requires --smp")
            if self.intra_max_cu != 32:
                raise ValueError("AMP requires 32x32 CUs (quarter "
                                 "splits at 8-pixel granularity)")
        if self.source_scan_type not in (0, 1, 2):
            raise ValueError("source_scan_type must be 0/1/2 "
                             "(progressive/tff/bff)")
        if self.tier not in ("main", "high"):
            raise ValueError("tier must be main or high")
        if self.level is not None:
            from kvazaar_jax.bitstream.headers import (_LEVELS,
                                                       compute_level_idc)
            try:
                idc = int(round(float(self.level) * 30))
            except ValueError:
                raise ValueError(f"bad level: {self.level!r}")
            if idc not in {lv[0] for lv in _LEVELS}:
                raise ValueError(f"unknown level {self.level}")
            fps = self.framerate_num / max(self.framerate_denom, 1)
            need = compute_level_idc(self.width, self.height, fps)
            if idc < need:
                raise ValueError(
                    f"level {self.level} too low for {self.width}x"
                    f"{self.height}@{fps:g} (needs level "
                    f"{need / 30:g}; A.4.1 limits)")
            if self.tier == "high" and idc < 120:
                raise ValueError("high tier starts at level 4 (A.4)")
        if self.threads < 0 or self.owf < 0:
            raise ValueError("threads/owf must be >= 0")
        if self.me not in ("full", "hexbs", "tz", "dia", "full8",
                          "full16", "full32", "full64"):
            raise ValueError(f"unknown --me algorithm: {self.me}")
        if self.source_scan_type:
            if self.height % (4 if self.chroma_format == 420 else 2):
                raise ValueError("interlaced coding needs frame height "
                                 "divisible by 4 (4:2:0 fields)")
            if self.gop_len > 1:
                raise ValueError("interlace with B pyramids is not "
                                 "implemented (low-delay only)")
        if self.slices not in ("none", "wpp", "tiles"):
            raise ValueError("slices must be none/wpp/tiles")
        if self.slices == "wpp":
            if not self.wpp:
                raise ValueError("slices=wpp requires WPP")
            if (self.tiles_x, self.tiles_y) != (1, 1):
                raise ValueError("slices=wpp with tiles is not "
                                 "implemented")
        if self.slices == "tiles":
            if (self.tiles_x, self.tiles_y) == (1, 1):
                raise ValueError("slices=tiles requires --tiles")
            if self.wpp:
                raise ValueError("slices=tiles with WPP substreams is "
                                 "not implemented")
        if self.slices != "none" and (self.roi is not None
                                      or self.aq > 0):
            raise ValueError("per-CTU QP with --slices is not "
                             "implemented")
        if not (0 <= self.overscan <= 2):
            raise ValueError("overscan must be 0/1/2")
        if not (0 <= self.videoformat <= 5):
            raise ValueError("videoformat must be 0..5")
        if not (0 <= self.chromaloc <= 5):
            raise ValueError("chromaloc must be 0..5")
        return self

    def set(self, name: str, value: str) -> "Config":
        """String-keyed option setter (analogue of kvz_config_parse)."""
        name = name.replace("-", "_")
        if name == "gop":
            # --gop: 0 = low delay IPPP, 4/8 = B pyramid, lp-g#d#t# =
            # low-delay structure (src/cfg.c:885).
            if value.startswith("lp-"):
                import re
                m = re.fullmatch(r"lp-g(\d+)d(\d+)t(\d+)", value)
                if not m:
                    raise ValueError(
                        "GOP syntax: lp-g#d#t#, e.g. lp-g4d2t1")
                self.lp_gop = tuple(int(x) for x in m.groups())
                self.gop_len = 0
            else:
                self.gop_len = int(value)
                self.lp_gop = None
            return self
        if name == "tiles":
            tx, ty = value.lower().split("x")
            self.tiles_x, self.tiles_y = int(tx), int(ty)
            return self
        if name == "source_scan_type":
            names = {"progressive": 0, "tff": 1, "bff": 2}
            self.source_scan_type = names.get(value.lower())
            if self.source_scan_type is None:
                self.source_scan_type = int(value)
            return self
        if not hasattr(self, name):
            raise KeyError(f"unknown option: {name}")
        cur = getattr(self, name)
        if isinstance(cur, bool):
            setattr(self, name, value.lower() in ("1", "true", "yes", "on"))
        elif isinstance(cur, int):
            setattr(self, name, int(value))
        elif isinstance(cur, float):
            setattr(self, name, float(value))
        else:
            setattr(self, name, value)
        return self


PRESETS = {
    # Reference preset ladder (src/cfg.c:386, 23 options per preset)
    # mapped onto the implemented tools — every knob a preset sets is
    # real (validate() enforces it).  Each preset is a full coherent
    # operating point: GOP structure, refs, bipred, CU ranges, RDO
    # depth, sao/rdoq/signhide, ME.  Deliberate deviations from the
    # reference ladder, documented:
    #  - ultrafast..veryfast keep a FIXED 16 intra grid (reference
    #    uses 16-8) — speed-first.
    #  - rd levels: the reference's rd0+early-termination ladder maps
    #    to our rd1 (SATD + MPM re-rank) from faster up; rd2 (true
    #    roundtrip re-rank) from slow up.
    #  - multi-ref applies to low-delay structures; B pyramids run one
    #    ref per list (ref kept at 1 with --gop 8).
    #  - veryslow/placebo skip SMP/AMP/tskip (fixed-grid-only tools)
    #    in favor of full variable trees.
    # pu-depth mapping: depth d = CU size 64>>d; intra "1-4" clamps to
    # min CU 8 (4x4 NxN is the dedicated all-intra operating point).
    "ultrafast": dict(rd=0, signhide=False, sao=False, me_range=16,
                      me_subpel=True, intra_max_cu=16, intra_min_cu=16,
                      inter_min_cu=8, inter_max_cu=16,
                      lp_gop=(4, 4, 1), ref_frames=1, bipred=False),
    "superfast": dict(rd=0, signhide=False, sao=True, me_range=16,
                      intra_max_cu=16, intra_min_cu=16,
                      inter_min_cu=8, inter_max_cu=16,
                      lp_gop=(4, 4, 1), ref_frames=1, bipred=False),
    "veryfast": dict(rd=0, signhide=False, sao=True, me_range=16,
                     intra_max_cu=16, intra_min_cu=16,
                     inter_min_cu=8, inter_max_cu=32,
                     lp_gop=(4, 4, 1), ref_frames=1, bipred=False),
    "faster": dict(rd=1, signhide=False, sao=True, me_range=16,
                   intra_max_cu=16, intra_min_cu=8,
                   inter_min_cu=8, inter_max_cu=32,
                   lp_gop=(4, 4, 1), ref_frames=1, bipred=False),
    "fast": dict(rd=1, signhide=False, sao=True, me_range=16,
                 intra_min_cu=8, intra_max_cu=32,
                 inter_min_cu=8, inter_max_cu=32,
                 lp_gop=(4, 4, 1), ref_frames=2, bipred=False),
    "medium": dict(rd=1, rdoq=True, signhide=False, sao=True,
                   me_range=16, intra_min_cu=8, intra_max_cu=32,
                   inter_min_cu=8, inter_max_cu=64,
                   gop_len=8, intra_period=0, ref_frames=1),
    "slow": dict(rd=2, rdoq=True, signhide=False, sao=True,
                 me_range=32, intra_min_cu=8, intra_max_cu=32,
                 inter_min_cu=8, inter_max_cu=64,
                 gop_len=8, intra_period=0, ref_frames=1, bipred=True),
    "slower": dict(rd=2, rdoq=True, signhide=True, sao=True,
                   me_range=32, intra_min_cu=8, intra_max_cu=64,
                   inter_min_cu=8, inter_max_cu=64,
                   gop_len=8, intra_period=0, ref_frames=1,
                   bipred=True),
    "veryslow": dict(rd=2, rdoq=True, signhide=True, sao=True,
                     me_range=32, intra_min_cu=8, intra_max_cu=64,
                     inter_min_cu=8, inter_max_cu=64,
                     gop_len=8, intra_period=0, ref_frames=1,
                     bipred=True),
    "placebo": dict(rd=2, rdoq=True, signhide=True, sao=True,
                    me_range=64, intra_min_cu=8, intra_max_cu=64,
                    inter_min_cu=8, inter_max_cu=64,
                    gop_len=8, intra_period=0, ref_frames=1,
                    bipred=True),
}


def config_from_preset(name: str, **overrides) -> Config:
    cfg = Config()
    for k, v in PRESETS[name].items():
        setattr(cfg, k, v)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def lp_gop_table(g: int, d: int, t: int, ref_frames: int):
    """Low-delay GOP table: per position 1..g a dict with poc_offset,
    layer, qp_offset and the negative-reference POC deltas.

    Re-derivation of the reference's kvz_config_process_lp_gop
    (src/cfg.c:1237): layer from the depth modulos, first ref the
    previous frame (or the nearest shallower frame when t > 1), the
    remaining refs earlier keyframes g apart."""
    depth_modulos = [0] * 8
    for dd in range(d):
        depth_modulos[d - 1 - dd] = 1 << dd
    depth_modulos[0] = g
    table = []
    for pos in range(1, g + 1):
        layer = 1
        while layer < d and (pos % depth_modulos[layer - 1]):
            layer += 1
        if t > 1:
            if pos % t == 0:
                first = t
            else:
                r = pos - 1
                while r > 0 and table[r - 1]["layer"] >= layer:
                    r -= 1
                if r > 0 and table[r - 1]["layer"] < layer:
                    first = pos - table[r - 1]["poc_offset"]
                else:
                    first = pos % g if pos % g else g
        else:
            first = 1
        refs = [first]
        keyframe = pos
        for _ in range(1, ref_frames):
            while keyframe == refs[-1]:
                keyframe += g
            refs.append(keyframe)
        table.append(dict(poc_offset=pos, layer=layer,
                          qp_offset=layer, ref_neg=refs))
    return table
