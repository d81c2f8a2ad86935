"""FIC decoder: extract ensemble/service information from the FIC channel
for the RC `ensemble info` surface (port of src/FigParser.{h,cpp}
FICDecoder and src/CharsetTools.cpp; EDI/monitoring path only -- the
modulator itself treats the FIC as opaque bits).

Covers the reference's full FIG set (src/FigParser.cpp:132-186, 650-680):
FIG 0/0 (ensemble info), 0/1 (sub-channel organization), 0/2 (service
organisation, DAB/DAB+), 0/5 (component language), 0/8 (component global
definition), 0/9 (country/LTO/international table), 0/10 (date & time),
0/13 (user applications / Slideshow), 0/17 (programme type), 0/18
(announcement support), 0/19 (announcement switching), and FIG 1/0, 1/1,
1/4 labels with EBU Latin -> UTF-8 conversion.

The port's copy of dabmod_tpu/io/fic_decoder.py, with the CRC of
dabmod_tpu/io/edi.py:29-49, which the port's io/edi.py imports from here.
"""
from __future__ import annotations

import dataclasses


# ---------------------------------------------------------------------------
# CRC16-CCITT (poly 0x1021, init 0xFFFF, final xor 0xFFFF -- lib/crc.c)
# ---------------------------------------------------------------------------

def _crc_table():
    tab = []
    for b in range(256):
        crc = b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) & 0xFFFF
        tab.append(crc)
    return tab


_CRC_TAB = _crc_table()


def crc16(data: bytes, init: int = 0xFFFF) -> int:
    crc = init
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC_TAB[((crc >> 8) ^ b) & 0xFF]
    return crc ^ 0xFFFF

# EBU Latin based repertoire (ETSI TS 101 756 Annex C), positions 0x00-0x7F
# that differ from ASCII plus the upper half; unmapped entries decode to
# their ASCII value or U+FFFD.
_EBU_HIGH = (
    "áàéèíìóòúùÑÇŞβ¡Ÿ"
    "âäêëîïôöûüñçşğıÿ"
    "ĶŅ©ĢĞěňőĦħŐłĀŪ§Ä"
    "ąēīōū±²³±ŗŖ¼½¾£$"
    "ĂĈĎĚĹĽŃÔŘŚŤŹŽŻÐŧ"
    "ăĉďěĺľńôřśťźžżđŀ"
    "ÁÀÉÈÍÌÓÒÚÙŘČŠŽÐĿ"
    "áàéèíìóòúùřčšžđŀ")

# FIG 0/1 short-form UEP table (EN 300 401 Table 6;
# ref: src/FigParser.cpp:896-913)
UEP_SIZES = (
    16, 21, 24, 29, 35, 24, 29, 35, 42, 52, 29, 35, 42, 52, 32, 42,
    48, 58, 70, 40, 52, 58, 70, 84, 48, 58, 70, 84, 104, 58, 70, 84,
    104, 64, 84, 96, 116, 140, 80, 104, 116, 140, 168, 96, 116, 140, 168,
    208, 116, 140, 168, 208, 232, 128, 168, 192, 232, 280, 160, 208, 280,
    192, 280, 416)
UEP_PLS = (
    5, 4, 3, 2, 1, 5, 4, 3, 2, 1, 5, 4, 3, 2, 5, 4,
    3, 2, 1, 5, 4, 3, 2, 1, 5, 4, 3, 2, 1, 5, 4, 3,
    2, 5, 4, 3, 2, 1, 5, 4, 3, 2, 1, 5, 4, 3, 2, 1,
    5, 4, 3, 2, 1, 5, 4, 3, 2, 1, 5, 4, 2, 5, 3, 1)
UEP_BITRATES = (
    32, 32, 32, 32, 32, 48, 48, 48, 48, 48, 56, 56, 56, 56, 64, 64,
    64, 64, 64, 80, 80, 80, 80, 80, 96, 96, 96, 96, 96, 112, 112, 112,
    112, 128, 128, 128, 128, 128, 160, 160, 160, 160, 160, 192, 192, 192,
    192, 192, 224, 224, 224, 224, 224, 256, 256, 256, 256, 256, 320, 320,
    320, 384, 384, 384)
EEP_A_SIZE_FACTORS = (12, 8, 6, 4)
EEP_B_SIZE_FACTORS = (27, 21, 18, 15)

LANGUAGES_0X00 = (
    "unknown/not applicable", "Albanian", "Breton", "Catalan", "Croatian",
    "Welsh", "Czech", "Danish", "German", "English", "Spanish", "Esperanto",
    "Estonian", "Basque", "Faroese", "French", "Frisian", "Irish", "Gaelic",
    "Galician", "Icelandic", "Italian", "Sami", "Latin", "Latvian",
    "Luxembourgian", "Lithuanian", "Hungarian", "Maltese", "Dutch",
    "Norwegian", "Occitan", "Polish", "Portuguese", "Romanian", "Romansh",
    "Serbian", "Slovak", "Slovene", "Finnish", "Swedish", "Turkish",
    "Flemish", "Walloon")
LANGUAGES_0X7F_DOWN = (
    "Amharic", "Arabic", "Armenian", "Assamese", "Azerbaijani", "Bambora",
    "Belorussian", "Bengali", "Bulgarian", "Burmese", "Chinese", "Chuvash",
    "Dari", "Fulani", "Georgian", "Greek", "Gujurati", "Gurani", "Hausa",
    "Hebrew", "Hindi", "Indonesian", "Japanese", "Kannada", "Kazakh",
    "Khmer", "Korean", "Laotian", "Macedonian", "Malagasay", "Malaysian",
    "Moldavian", "Marathi", "Ndebele", "Nepali", "Oriya", "Papiamento",
    "Persian", "Punjabi", "Pushtu", "Quechua", "Russian", "Rusyn",
    "Serbo-Croat", "Shona", "Sinhalese", "Somali", "Sranan Tongo",
    "Swahili", "Tadzhik", "Tamil", "Tatar", "Telugu", "Thai", "Ukranian",
    "Urdu", "Uzbek", "Vietnamese", "Zulu")
PTYS_RDS = (
    "No programme type", "News", "Current Affairs", "Information", "Sport",
    "Education", "Drama", "Culture", "Science", "Varied", "Pop Music",
    "Rock Music", "Easy Listening Music", "Light Classical",
    "Serious Classical", "Other Music", "Weather/meteorology",
    "Finance/Business", "Children's programmes", "Social Affairs",
    "Religion", "Phone In", "Travel", "Leisure", "Jazz Music",
    "Country Music", "National Music", "Oldies Music", "Folk Music",
    "Documentary")
PTYS_RBDS = (
    "No program type", "News", "Information", "Sports", "Talk", "Rock",
    "Classic Rock", "Adult Hits", "Soft Rock", "Top 40", "Country",
    "Oldies", "Soft", "Nostalgia", "Jazz", "Classical",
    "Rhythm and Blues", "Soft Rhythm and Blues", "Foreign Language",
    "Religious Music", "Religious Talk", "Personality", "Public",
    "College", "(rfu)", "(rfu)", "(rfu)", "(rfu)", "(rfu)", "Weather")
ASU_TYPES = (
    "Alarm", "Road Traffic flash", "Transport flash", "Warning/Service",
    "News flash", "Area weather flash", "Event announcement",
    "Special event", "Programme Information", "Sport report",
    "Financial report")


def ebu_latin_to_utf8(data: bytes) -> str:
    out = []
    for b in data:
        if b == 0:
            break
        if b < 0x80:
            out.append(chr(b))
        else:
            idx = b - 0x80
            out.append(_EBU_HIGH[idx] if idx < len(_EBU_HIGH) else "�")
    return "".join(out).strip()


def language_to_string(value: int) -> str:
    """ref: src/FigParser.cpp:963-975."""
    if 0 <= value < len(LANGUAGES_0X00):
        return LANGUAGES_0X00[value]
    if 0x45 <= value <= 0x7F:
        return LANGUAGES_0X7F_DOWN[0x7F - value]
    return f"unknown (0x{value:02X})"


def pty_to_string(value: int, inter_table_id: int) -> str:
    """ref: src/FigParser.cpp:1027-1036."""
    if inter_table_id == 0x01:
        return PTYS_RDS[value] if value < len(PTYS_RDS) else "(not used)"
    if inter_table_id == 0x02:
        return PTYS_RBDS[value] if value < len(PTYS_RBDS) else "(not used)"
    return "(unknown)"


def lto_to_string(lto: int) -> str:
    half_hours = abs(lto)
    return (f"{'-' if lto < 0 else '+'}{half_hours // 2:02d}:"
            f"{(half_hours % 2) * 30:02d}")


@dataclasses.dataclass
class Subchannel:
    start: int = -1
    size: int = -1
    pl: str = ""
    bitrate: int = -1
    language: int = -1

    def to_json(self) -> dict:
        d = {"start": self.start, "size": self.size,
             "protection": self.pl, "bitrate_kbps": self.bitrate}
        if self.language >= 0:
            d["language"] = language_to_string(self.language)
        return d


@dataclasses.dataclass
class Service:
    sid: int
    label: str = ""
    short_label: str = ""
    # subchid -> dab_plus flag (FIG 0/2 audio components)
    audio_comps: dict = dataclasses.field(default_factory=dict)
    pri_comp_subchid: int = -1
    comp_defs: dict = dataclasses.field(default_factory=dict)  # scids->subch
    comp_labels: dict = dataclasses.field(default_factory=dict)
    comp_sls_uas: dict = dataclasses.field(default_factory=dict)
    pty_static: int = -1
    pty_dynamic: int = -1
    asu_flags: int = 0
    cids: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class EnsembleInfo:
    eid: int = 0
    label: str = ""
    short_label: str = ""
    al_flag: bool = False
    ecc: int = -1
    lto: int = 0
    inter_table_id: int = -1
    utc_time: str = ""
    services: dict = dataclasses.field(default_factory=dict)
    subchannels: dict = dataclasses.field(default_factory=dict)
    asw_clusters: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        ens = {"id": f"0x{self.eid:04x}", "label": self.label,
               "shortlabel": self.short_label, "alarm": self.al_flag}
        if self.ecc >= 0:
            ens["ecc"] = f"0x{self.ecc:02x}"
            ens["lto"] = lto_to_string(self.lto)
        if self.inter_table_id >= 0:
            ens["international_table"] = self.inter_table_id
        if self.utc_time:
            ens["utc_time"] = self.utc_time
        services = []
        for s in sorted(self.services.values(), key=lambda s: s.sid):
            comps = []
            for subchid, dab_plus in sorted(s.audio_comps.items()):
                comp = {"type": "DAB+" if dab_plus else "DAB",
                        "subchannel_id": subchid,
                        "primary": subchid == s.pri_comp_subchid}
                sc = self.subchannels.get(subchid)
                if sc is not None:
                    comp["subchannel"] = sc.to_json()
                comps.append(comp)
            for scids, subchid in sorted(s.comp_defs.items()):
                entry = {"scids": scids, "subchannel_id": subchid}
                if scids in s.comp_labels:
                    entry["label"] = s.comp_labels[scids]
                comps.append(entry)
            svc = {"sid": f"0x{s.sid:04x}", "label": s.label,
                   "shortlabel": s.short_label, "components": comps}
            if s.pty_static >= 0:
                svc["pty"] = pty_to_string(
                    s.pty_static, self.inter_table_id)
            if s.pty_dynamic >= 0:
                svc["pty_dynamic"] = pty_to_string(
                    s.pty_dynamic, self.inter_table_id)
            if s.comp_sls_uas:
                svc["user_applications"] = [
                    {"scids": k, "type": "slideshow",
                     "ua_data": list(v)}
                    for k, v in sorted(s.comp_sls_uas.items())]
            if s.asu_flags:
                svc["announcements"] = {
                    "flags": [ASU_TYPES[i] for i in range(16)
                              if (s.asu_flags >> i) & 1 and i < len(ASU_TYPES)],
                    "clusters": sorted(s.cids)}
            services.append(svc)
        out = {"ensemble": ens, "services": services,
               "subchannels": {str(k): v.to_json() for k, v in
                               sorted(self.subchannels.items())}}
        if self.asw_clusters:
            out["announcement_switching"] = {
                f"0x{cid:02x}": {"flags": flags, "subchannel_id": subchid}
                for cid, (flags, subchid) in
                sorted(self.asw_clusters.items())}
        return out


class FICDecoder:
    FIB_LEN = 32      # 30 data + 2 CRC

    def __init__(self):
        self.ensemble = EnsembleInfo()
        self._utc_dt_long = False

    def process(self, fic: bytes):
        for i in range(0, len(fic) - self.FIB_LEN + 1, self.FIB_LEN):
            self._process_fib(fic[i:i + self.FIB_LEN])

    # -- per-service/subchannel accessors (auto-create like the reference's
    #    GetService/GetSubchannel) --
    def _service(self, sid: int) -> Service:
        return self.ensemble.services.setdefault(sid, Service(sid))

    def _subchannel(self, subchid: int) -> Subchannel:
        return self.ensemble.subchannels.setdefault(subchid, Subchannel())

    def _process_fib(self, fib: bytes):
        if crc16(fib[:30]) != int.from_bytes(fib[30:32], "big"):
            return
        offset = 0
        while offset < 30:
            head = fib[offset]
            if head == 0xFF:   # end marker
                break
            fig_type = head >> 5
            fig_len = head & 0x1F
            if fig_len == 0 or offset + 1 + fig_len > 30:
                break
            body = fib[offset + 1:offset + 1 + fig_len]
            if fig_type == 0:
                self._fig0(body)
            elif fig_type == 1:
                self._fig1(body)
            offset += 1 + fig_len

    # ------------------------------------------------------------ FIG 0
    def _fig0(self, body: bytes):
        if not body:
            return
        header = body[0]
        oe = (header >> 6) & 1
        pd = (header >> 5) & 1
        ext = header & 0x1F
        if oe:
            return
        data = body[1:]
        handler = getattr(self, f"_fig0_{ext}", None)
        if handler is not None:
            handler(data, pd)

    def _fig0_0(self, data: bytes, pd: int):
        # ensemble information (ref: src/FigParser.cpp:188-208)
        if len(data) < 4:
            return
        self.ensemble.eid = (data[0] << 8) | data[1]
        self.ensemble.al_flag = bool(data[2] & 0x20)

    def _fig0_1(self, data: bytes, pd: int):
        # basic sub-channel organization (ref: src/FigParser.cpp:210-268)
        i = 0
        while i + 2 <= len(data):
            subchid = data[i] >> 2
            start = ((data[i] & 0x03) << 8) | data[i + 1]
            i += 2
            if i >= len(data):
                break
            sc = Subchannel(start=start)
            if data[i] & 0x80:      # long form
                if i + 2 > len(data):
                    break
                option = (data[i] & 0x70) >> 4
                pl = (data[i] & 0x0C) >> 2
                size = ((data[i] & 0x03) << 8) | data[i + 1]
                if option == 0:
                    sc.size = size
                    sc.pl = f"EEP {pl + 1}-A"
                    sc.bitrate = size // EEP_A_SIZE_FACTORS[pl] * 8
                elif option == 1:
                    sc.size = size
                    sc.pl = f"EEP {pl + 1}-B"
                    sc.bitrate = size // EEP_B_SIZE_FACTORS[pl] * 32
                i += 2
            else:                   # short form (UEP table index)
                if not data[i] & 0x40:
                    idx = data[i] & 0x3F
                    sc.size = UEP_SIZES[idx]
                    sc.pl = f"UEP {UEP_PLS[idx]}"
                    sc.bitrate = UEP_BITRATES[idx]
                i += 1
            if sc.size >= 0:
                cur = self._subchannel(subchid)
                sc.language = cur.language
                self.ensemble.subchannels[subchid] = sc

    def _fig0_2(self, data: bytes, pd: int):
        # service organisation (ref: src/FigParser.cpp:270-321); the
        # reference handles programme (16-bit SId) audio services only
        i = 0
        while i + 3 <= len(data):
            sid = (data[i] << 8) | data[i + 1]
            i += 2
            ncomp = data[i] & 0x0F
            i += 1
            for _ in range(ncomp):
                if i + 2 > len(data):
                    return
                tmid = data[i] >> 6
                if tmid == 0:       # MSC stream audio
                    ascty = data[i] & 0x3F
                    subchid = data[i + 1] >> 2
                    ps = bool(data[i + 1] & 0x02)
                    ca = bool(data[i + 1] & 0x01)
                    if not ca and ascty in (0, 63):
                        svc = self._service(sid)
                        svc.audio_comps[subchid] = (ascty == 63)
                        if ps:
                            svc.pri_comp_subchid = subchid
                i += 2

    def _fig0_5(self, data: bytes, pd: int):
        # service component language (ref: src/FigParser.cpp:323-356)
        i = 0
        while i < len(data):
            if data[i] & 0x80:      # long form - not relevant
                i += 3
                continue
            if not data[i] & 0x40 and i + 1 < len(data):  # MSC short form
                subchid = data[i] & 0x3F
                self._subchannel(subchid).language = data[i + 1]
            i += 2

    def _fig0_8(self, data: bytes, pd: int):
        # service component global definition
        # (ref: src/FigParser.cpp:358-403)
        i = 0
        while i + 4 <= len(data):
            sid = (data[i] << 8) | data[i + 1]
            i += 2
            ext_flag = bool(data[i] & 0x80)
            scids = data[i] & 0x0F
            i += 1
            if data[i] & 0x80:      # long form - not relevant
                i += 2
            else:
                if not data[i] & 0x40:
                    subchid = data[i] & 0x3F
                    self._service(sid).comp_defs[scids] = subchid
                i += 1
            if ext_flag:
                i += 1

    def _fig0_9(self, data: bytes, pd: int):
        # country, LTO, international table (ref: src/FigParser.cpp:405-433)
        if len(data) < 3:
            return
        self.ensemble.lto = (-1 if data[0] & 0x20 else 1) * (data[0] & 0x1F)
        self.ensemble.ecc = data[1]
        self.ensemble.inter_table_id = data[2]

    def _fig0_10(self, data: bytes, pd: int):
        # date and time (ref: src/FigParser.cpp:435-489)
        if len(data) < 4:
            return
        utc_flag = bool(data[2] & 0x08)
        if not utc_flag and self._utc_dt_long:
            return
        mjd = ((data[0] & 0x7F) << 10) | (data[1] << 2) | (data[2] >> 6)
        y0 = int((mjd - 15078.2) // 365.25)
        m0 = int((mjd - 14956.1 - int(y0 * 365.25)) // 30.6001)
        d = mjd - 14956 - int(y0 * 365.25) - int(m0 * 30.6001)
        k = 1 if m0 in (14, 15) else 0
        year = 1900 + y0 + k
        month = m0 - 1 - k * 12
        hour = ((data[2] & 0x07) << 2) | (data[3] >> 6)
        minute = data[3] & 0x3F
        if utc_flag:
            if len(data) < 6:
                return
            sec = data[4] >> 2
            ms = ((data[4] & 0x03) << 8) | data[5]
            self._utc_dt_long = True
            self.ensemble.utc_time = (
                f"{year:04d}-{month:02d}-{d:02d} "
                f"{hour:02d}:{minute:02d}:{sec:02d}.{ms:03d}")
        else:
            self.ensemble.utc_time = (
                f"{year:04d}-{month:02d}-{d:02d} {hour:02d}:{minute:02d}")

    def _fig0_13(self, data: bytes, pd: int):
        # user application information (ref: src/FigParser.cpp:491-530)
        i = 0
        while i + 3 <= len(data):
            sid = (data[i] << 8) | data[i + 1]
            i += 2
            scids = data[i] >> 4
            n_uas = data[i] & 0x0F
            i += 1
            for _ in range(n_uas):
                if i + 2 > len(data):
                    return
                ua_type = (data[i] << 3) | (data[i + 1] >> 5)
                ua_len = data[i + 1] & 0x1F
                i += 2
                if ua_type == 0x002:    # Slideshow
                    self._service(sid).comp_sls_uas.setdefault(
                        scids, bytes(data[i:i + ua_len]))
                i += ua_len

    def _fig0_17(self, data: bytes, pd: int):
        # programme type (ref: src/FigParser.cpp:532-573)
        i = 0
        while i + 4 <= len(data):
            sid = (data[i] << 8) | data[i + 1]
            sd = bool(data[i + 2] & 0x80)
            l_flag = bool(data[i + 2] & 0x20)
            cc_flag = bool(data[i + 2] & 0x10)
            i += 3
            if l_flag:
                i += 1
            if i >= len(data):
                return
            pty = data[i] & 0x1F
            i += 1
            if cc_flag:
                i += 1
            svc = self._service(sid)
            if sd:
                svc.pty_dynamic = pty
            else:
                svc.pty_static = pty

    def _fig0_18(self, data: bytes, pd: int):
        # announcement support (ref: src/FigParser.cpp:575-612)
        i = 0
        while i + 5 <= len(data):
            sid = (data[i] << 8) | data[i + 1]
            asu_flags = (data[i + 2] << 8) | data[i + 3]
            n_clusters = data[i + 4] & 0x1F
            i += 5
            cids = set()
            for _ in range(n_clusters):
                if i >= len(data):
                    return
                cids.add(data[i])
                i += 1
            svc = self._service(sid)
            svc.asu_flags = asu_flags
            svc.cids = cids

    def _fig0_19(self, data: bytes, pd: int):
        # announcement switching (ref: src/FigParser.cpp:614-648)
        i = 0
        while i + 4 <= len(data):
            cid = data[i]
            asw_flags = (data[i + 1] << 8) | data[i + 2]
            region_flag = bool(data[i + 3] & 0x40)
            subchid = data[i + 3] & 0x3F
            i += 5 if region_flag else 4
            self.ensemble.asw_clusters[cid] = (asw_flags, subchid)

    # ------------------------------------------------------------ FIG 1
    def _fig1(self, body: bytes):
        # labels (ref: src/FigParser.cpp:650-712)
        if len(body) < 1:
            return
        charset = body[0] >> 4
        oe = (body[0] >> 3) & 1
        ext = body[0] & 0x7
        data = body[1:]
        if oe or charset != 0:    # only EBU Latin, like the reference
            return
        if ext in (0, 1):
            len_id = 2
        elif ext == 4:
            if data and data[0] & 0x80:     # data services not handled
                return
            len_id = 3
        else:
            return
        if len(data) != len_id + 16 + 2:
            return
        chars = data[len_id:len_id + 16]
        mask = int.from_bytes(data[len_id + 16:len_id + 18], "big")
        label = ebu_latin_to_utf8(chars)
        short = _short_label(chars, mask)
        if ext == 0:
            self.ensemble.eid = (data[0] << 8) | data[1]
            self.ensemble.label = label
            self.ensemble.short_label = short
        elif ext == 1:
            sid = (data[0] << 8) | data[1]
            svc = self._service(sid)
            svc.label, svc.short_label = label, short
        else:   # ext == 4: service component label
            scids = data[0] & 0x0F
            sid = (data[1] << 8) | data[2]
            self._service(sid).comp_labels[scids] = label


def _short_label(chars: bytes, flags: int) -> str:
    out = []
    for i in range(16):
        if flags & (0x8000 >> i) and chars[i]:
            out.append(chars[i:i + 1])
    return ebu_latin_to_utf8(b"".join(out))
