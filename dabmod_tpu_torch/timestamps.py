"""SFN timestamp reconstruction from ETI MNSC + TIST.

Port of the reference's TimestampDecoder (src/TimestampDecoder.cpp:86-237):
the MNSC carries a BCD UTC time spread over the four frame phases; TIST gives
the 1/16.384 MHz offset from the PPS edge.  Second boundaries detected from
PPS wrap-around inhibit the next MNSC second update for 2 frames.

The port's copy of dabmod_tpu/timestamps.py.
"""
from __future__ import annotations

import calendar
import dataclasses


@dataclasses.dataclass
class FrameTimestamp:
    valid: bool = False
    seconds: int = 0
    pps: int = 0                    # units of 1/16384000 s
    fct: int = -1
    fp: int = 0

    def as_seconds(self) -> float:
        return self.seconds + self.pps / 16_384_000.0

    def offset(self, delta: float) -> "FrameTimestamp":
        total = self.as_seconds() + delta
        secs = int(total)
        pps = int(round((total - secs) * 16_384_000))
        if pps >= 16_384_000:
            secs += 1
            pps -= 16_384_000
        return FrameTimestamp(self.valid, secs, pps, self.fct, self.fp)


class TimestampDecoder:
    def __init__(self, offset_s: float = 0.0):
        self.offset_s = offset_s
        self.time_secs = 0
        self.time_pps = 0
        self.enable_decode = False
        self.full_timestamp_received = False
        self.inhibit_second_update = 0
        self.latest_fct = -1
        self.latest_fp = 0
        self._tm = [0, 0, 0, 1, 1, 1970]   # sec, min, hour, mday, mon, year

    # ----------------------------------------------------------- MNSC
    def _push_mnsc(self, fp: int, mnsc: int):
        b0 = mnsc & 0xFF
        b1 = (mnsc >> 8) & 0xFF
        if fp == 0:
            ty = b0 & 0xF
            ident = (b0 >> 4) & 0xF
            self.enable_decode = (ty == 0 and ident == 0)
            self._tm = [0, 0, 0, 1, 1, 1970]
        elif fp == 1:
            self._tm[0] = ((b0 >> 4) & 0x7) * 10 + (b0 & 0xF)   # seconds
            self._tm[1] = ((b1 >> 4) & 0x7) * 10 + (b1 & 0xF)   # minutes
            sync_to_frame = (b1 >> 7) & 1
            if not sync_to_frame:
                self.enable_decode = False
        elif fp == 2:
            self._tm[2] = ((b0 >> 4) & 0xF) * 10 + (b0 & 0xF)   # hours
            self._tm[3] = ((b1 >> 4) & 0xF) * 10 + (b1 & 0xF)   # day
        elif fp == 3:
            self._tm[4] = ((b0 >> 4) & 0xF) * 10 + (b0 & 0xF)   # month
            self._tm[5] = 2000 + ((b1 >> 4) & 0xF) * 10 + (b1 & 0xF)
            if self.enable_decode:
                sec, minute, hour, mday, mon, year = self._tm
                secs = calendar.timegm(
                    (year, mon, mday, hour, minute, sec, 0, 0, 0))
                self._update_seconds(secs)

    def _update_seconds(self, secs: int):
        if self.inhibit_second_update > 0:
            self.inhibit_second_update -= 1
        else:
            self.time_secs = secs
            self.full_timestamp_received = True

    def _update_pps(self, pps: int):
        if self.time_pps > pps:
            # PPS wrapped: second boundary crossed between frames
            self.inhibit_second_update = 2
            self.time_secs += 1
        self.time_pps = pps

    # ----------------------------------------------------------- public
    def update_eti(self, fp: int, mnsc: int, pps: int, fct: int):
        self._update_pps(int(pps))
        self._push_mnsc(int(fp) & 0x3, int(mnsc))
        self.latest_fct = int(fct)
        self.latest_fp = int(fp)

    def update_edi(self, seconds_utc: int, pps: int, fct: int, fp: int):
        self.time_secs = int(seconds_utc)
        self.time_pps = int(pps)
        self.latest_fct = int(fct)
        self.latest_fp = int(fp)
        self.full_timestamp_received = True

    def timestamp(self) -> FrameTimestamp:
        ts = FrameTimestamp(self.full_timestamp_received, self.time_secs,
                            self.time_pps, self.latest_fct, self.latest_fp)
        return ts.offset(self.offset_s) if self.offset_s else ts

    def update_eti_batch(self, fps, mnscs, ppss, fcts,
                         cif_count: int) -> list[FrameTimestamp]:
        """Update over a batch of ETI frames; returns one FrameTimestamp per
        transmission frame -- the timestamp of its *earliest* ETI frame,
        which is what the SDR output transmits against
        (ref: src/output/SDR.cpp:135-201, src/BlockPartitioner metadata
        aggregation)."""
        out = []
        for i in range(len(fcts)):
            self.update_eti(int(fps[i]), int(mnscs[i]), int(ppss[i]),
                            int(fcts[i]))
            if i % cif_count == 0:
                out.append(self.timestamp())
        return out
