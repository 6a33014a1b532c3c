"""Raw-key -> StandardTagKey mapping layer.

Analog of symphonia-metadata/src/utils/std_tag.rs (:1-479): per-format
maps from raw tag keys to standard keys plus value parsers that can
yield a second derived tag (e.g. ``"3/12"`` -> track_number + track_total).
Readers call :func:`map_raw` and extend their tag list with the result;
unmapped keys surface as plain raw tags, exactly like the reference's
``add_mapped_tags``.

Map entries are ``std_key`` strings for plain string tags, or
``(kind, std_key[, second_std_key])`` tuples where ``kind`` is one of the
parser kinds below (std_tag.rs parse_* families).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional

from ..core.meta import RawTag, StandardTagKey as K

# ---------------------------------------------------------------------------
# Value parsers (std_tag.rs:101-360)
# ---------------------------------------------------------------------------


def _to_int(v: str) -> Optional[int]:
    try:
        return int(v.strip())
    except (ValueError, AttributeError):
        return None


def _parse_flag(v: str) -> Optional[bool]:
    s = v.strip().lower()
    if s in ("1", "true", "yes"):
        return True
    if s in ("0", "false", "no", ""):
        return False
    return None


def _parse_year(v: str) -> Optional[int]:
    m = re.match(r"\s*(\d{4})", v)
    return int(m.group(1)) if m else None


def map_raw(key: str, value: Any, pmap: dict) -> List[RawTag]:
    """Map one raw tag through a per-format parser map.

    Returns 1-2 RawTags: the original raw tag with ``std_key`` set when
    the key maps and the value parses (plus a derived second tag for
    pair-valued keys), or the plain raw tag otherwise."""
    ent = pmap.get(key.lower()) if isinstance(key, str) else None
    if ent is None:
        return [RawTag(key, value)]
    if isinstance(ent, str):
        return [RawTag(key, value, std_key=ent)]
    kind = ent[0]
    if not isinstance(value, (str, int, float, bool)):
        return [RawTag(key, value)]
    sval = str(value)
    if kind == "int":
        n = _to_int(sval)
        return [RawTag(key, n if n is not None else value,
                       std_key=ent[1] if n is not None else None)]
    if kind == "float":
        try:
            f = float(sval.strip())
        except ValueError:
            return [RawTag(key, value)]
        return [RawTag(key, f, std_key=ent[1])]
    if kind == "flag":
        b = _parse_flag(sval)
        return [RawTag(key, b if b is not None else value,
                       std_key=ent[1] if b is not None else None)]
    if kind == "year":
        y = _parse_year(sval)
        if y is None:
            return [RawTag(key, value)]
        return [RawTag(key, y, std_key=ent[1])]
    if kind == "pair":
        # "N" or "N/M" -> number (+ total when present and a second key
        # is mapped) — parse_track_number_exclusive / parse_disc_number.
        m = re.match(r"\s*(\d+)\s*(?:/\s*(\d+))?\s*$", sval)
        if not m:
            return [RawTag(key, value)]
        out = [RawTag(key, int(m.group(1)), std_key=ent[1])]
        if m.group(2) is not None and len(ent) > 2:
            out.append(RawTag(key, int(m.group(2)), std_key=ent[2]))
        return out
    return [RawTag(key, value, std_key=ent[1])]


# ---------------------------------------------------------------------------
# Vorbis comments (embedded/vorbis.rs:38-160)
# ---------------------------------------------------------------------------

VORBIS_MAP = {
    "accurateripcount": K.ACCURATE_RIP_COUNT,
    "accurateripcountalloffsets": K.ACCURATE_RIP_COUNT_ALL_OFFSETS,
    "accurateripcountwithoffset": K.ACCURATE_RIP_COUNT_WITH_OFFSET,
    "accurateripcrc": K.ACCURATE_RIP_CRC,
    "accurateripdiscid": K.ACCURATE_RIP_DISC_ID,
    "accurateripid": K.ACCURATE_RIP_ID,
    "accurateripoffset": K.ACCURATE_RIP_OFFSET,
    "accurateripresult": K.ACCURATE_RIP_RESULT,
    "accurateriptotal": K.ACCURATE_RIP_TOTAL,
    "acoustid_fingerprint": K.ACOUSTID_FINGERPRINT,
    "acoustid_id": K.ACOUSTID_ID,
    "album artist": K.ALBUM_ARTIST,
    "album": K.ALBUM,
    "albumartist": K.ALBUM_ARTIST,
    "albumartistsort": K.SORT_ALBUM_ARTIST,
    "albumsort": K.SORT_ALBUM,
    "arranger": K.ARRANGER,
    "artist": K.ARTIST,
    "artistsort": K.SORT_ARTIST,
    "author": K.WRITER,
    "barcode": K.IDENT_BARCODE,
    "bpm": ("int", K.BPM),
    "catalog #": K.IDENT_CATALOG_NUMBER,
    "catalog": K.IDENT_CATALOG_NUMBER,
    "catalognumber": K.IDENT_CATALOG_NUMBER,
    "catalogue #": K.IDENT_CATALOG_NUMBER,
    "cdtoc": K.CD_TOC,
    "comment": K.COMMENT,
    "compilation": ("flag", K.COMPILATION_FLAG),
    "composer": K.COMPOSER,
    "conductor": K.CONDUCTOR,
    "copyright": K.COPYRIGHT,
    "ctdbdiscconfidence": K.CUE_TOOLS_DB_DISC_CONFIDENCE,
    "ctdbtrackconfidence": K.CUE_TOOLS_DB_TRACK_CONFIDENCE,
    "date": K.RECORDING_DATE,
    "description": K.DESCRIPTION,
    "disc": ("pair", K.DISC_NUMBER, K.DISC_TOTAL),
    "discnumber": ("pair", K.DISC_NUMBER, K.DISC_TOTAL),
    "discsubtitle": K.DISC_SUBTITLE,
    "disctotal": ("int", K.DISC_TOTAL),
    "disk": ("pair", K.DISC_NUMBER, K.DISC_TOTAL),
    "disknumber": ("pair", K.DISC_NUMBER, K.DISC_TOTAL),
    "disksubtitle": K.DISC_SUBTITLE,
    "disktotal": ("int", K.DISC_TOTAL),
    "djmixer": K.MIX_DJ,
    "ean/upn": K.IDENT_EAN_UPN,
    "encoded-by": K.ENCODED_BY,
    "encodedby": K.ENCODED_BY,
    "encoder settings": K.ENCODER_SETTINGS,
    "encoder": K.ENCODER,
    "encoding": K.ENCODER_SETTINGS,
    "engineer": K.ENGINEER,
    "ensemble": K.ENSEMBLE,
    "genre": K.GENRE,
    "grouping": K.GROUPING,
    "isrc": K.IDENT_ISRC,
    "language": K.LANGUAGE,
    "label": K.LABEL,
    "labelno": K.IDENT_CATALOG_NUMBER,
    "license": K.LICENSE,
    "lyricist": K.LYRICIST,
    "lyrics": K.LYRICS,
    "media": K.MEDIA_FORMAT,
    "mixer": K.MIX_ENGINEER,
    "mood": K.MOOD,
    "musicbrainz_albumartistid": K.MUSICBRAINZ_ALBUM_ARTIST_ID,
    "musicbrainz_albumid": K.MUSICBRAINZ_ALBUM_ID,
    "musicbrainz_artistid": K.MUSICBRAINZ_ARTIST_ID,
    "musicbrainz_discid": K.MUSICBRAINZ_DISC_ID,
    "musicbrainz_originalalbumid": K.MUSICBRAINZ_ORIGINAL_ALBUM_ID,
    "musicbrainz_originalartistid": K.MUSICBRAINZ_ORIGINAL_ARTIST_ID,
    "musicbrainz_recordingid": K.MUSICBRAINZ_RECORDING_ID,
    "musicbrainz_releasegroupid": K.MUSICBRAINZ_RELEASE_GROUP_ID,
    "musicbrainz_releasetrackid": K.MUSICBRAINZ_RELEASE_TRACK_ID,
    "musicbrainz_trackid": K.MUSICBRAINZ_TRACK_ID,
    "musicbrainz_workid": K.MUSICBRAINZ_WORK_ID,
    "opus": K.OPUS,
    "organization": K.LABEL,
    "originaldate": K.ORIGINAL_RELEASE_DATE,
    "originalyear": ("year", K.ORIGINAL_RELEASE_YEAR),
    "part": K.PART,
    "partnumber": ("pair", K.PART_NUMBER, K.PART_TOTAL),
    "performer": K.PERFORMER,
    "producer": K.PRODUCER,
    "productnumber": K.IDENT_PN,
    "publisher": K.LABEL,
    "rating": ("int", K.RATING),
    "releasecountry": K.RELEASE_COUNTRY,
    "releasestatus": K.MUSICBRAINZ_RELEASE_STATUS,
    "releasetype": K.MUSICBRAINZ_RELEASE_TYPE,
    "remixer": K.REMIXER,
    "replaygain_album_gain": K.REPLAYGAIN_ALBUM_GAIN,
    "replaygain_album_peak": K.REPLAYGAIN_ALBUM_PEAK,
    "replaygain_reference_loudness": K.REPLAYGAIN_REFERENCE_LOUDNESS,
    "replaygain_track_gain": K.REPLAYGAIN_TRACK_GAIN,
    "replaygain_track_peak": K.REPLAYGAIN_TRACK_PEAK,
    "script": K.SCRIPT,
    "subtitle": K.TRACK_SUBTITLE,
    "title": K.TRACK_TITLE,
    "titlesort": K.SORT_TRACK_TITLE,
    "totaldiscs": ("int", K.DISC_TOTAL),
    "totaltracks": ("int", K.TRACK_TOTAL),
    "track": ("pair", K.TRACK_NUMBER, K.TRACK_TOTAL),
    "tracknumber": ("pair", K.TRACK_NUMBER, K.TRACK_TOTAL),
    "tracktotal": ("int", K.TRACK_TOTAL),
    "unsyncedlyrics": K.LYRICS,
    "upc": K.IDENT_UPC,
    "version": K.VERSION,
    "work": K.WORK,
    "writer": K.WRITER,
    "year": ("year", K.RECORDING_YEAR),
}

# ---------------------------------------------------------------------------
# APEv1/v2 item keys (ape.rs key map)
# ---------------------------------------------------------------------------

APE_MAP = {
    "accurateripcount": K.ACCURATE_RIP_COUNT,
    "accurateripcountalloffsets": K.ACCURATE_RIP_COUNT_ALL_OFFSETS,
    "accurateripcountwithoffset": K.ACCURATE_RIP_COUNT_WITH_OFFSET,
    "accurateripcrc": K.ACCURATE_RIP_CRC,
    "accurateripdiscid": K.ACCURATE_RIP_DISC_ID,
    "accurateripid": K.ACCURATE_RIP_ID,
    "accurateripoffset": K.ACCURATE_RIP_OFFSET,
    "accurateripresult": K.ACCURATE_RIP_RESULT,
    "accurateriptotal": K.ACCURATE_RIP_TOTAL,
    "acoustid_fingerprint": K.ACOUSTID_FINGERPRINT,
    "acoustid_id": K.ACOUSTID_ID,
    "album artist": K.ALBUM_ARTIST,
    "album": K.ALBUM,
    "albumartistsort": K.SORT_ALBUM_ARTIST,
    "albumsort": K.SORT_ALBUM,
    "arranger": K.ARRANGER,
    "artist": K.ARTIST,
    "artistsort": K.SORT_ARTIST,
    "asin": K.IDENT_ASIN,
    "bpm": ("int", K.BPM),
    "catalog": K.IDENT_CATALOG_NUMBER,
    "catalognumber": K.IDENT_CATALOG_NUMBER,
    "comment": K.COMMENT,
    "compilation": ("flag", K.COMPILATION_FLAG),
    "composer": K.COMPOSER,
    "composersort": K.SORT_COMPOSER,
    "conductor": K.CONDUCTOR,
    "copyright": K.COPYRIGHT,
    "disc": ("pair", K.DISC_NUMBER, K.DISC_TOTAL),
    "djmixer": K.MIX_DJ,
    "ean/upc": K.IDENT_EAN_UPN,
    "encodedby": K.ENCODED_BY,
    "encoder settings": K.ENCODER_SETTINGS,
    "encoder": K.ENCODER,
    "engineer": K.ENGINEER,
    "file": K.ORIGINAL_FILE,
    "genre": K.GENRE,
    "isbn": K.IDENT_ISBN,
    "isrc": K.IDENT_ISRC,
    "label": K.LABEL,
    "labelcode": K.LABEL_CODE,
    "language": K.LANGUAGE,
    "lyricist": K.LYRICIST,
    "lyrics": K.LYRICS,
    "media": K.MEDIA_FORMAT,
    "mixer": K.MIX_ENGINEER,
    "mood": K.MOOD,
    "movement": ("int", K.MOVEMENT_TOTAL),
    "movementname": K.MOVEMENT_NAME,
    "movementtotal": ("int", K.MOVEMENT_TOTAL),
    "mp3gain_album_minmax": K.MP3GAIN_ALBUM_MIN_MAX,
    "mp3gain_minmax": K.MP3GAIN_MIN_MAX,
    "mp3gain_undo": K.MP3GAIN_UNDO,
    "musicbrainz_albumartistid": K.MUSICBRAINZ_ALBUM_ARTIST_ID,
    "musicbrainz_albumid": K.MUSICBRAINZ_ALBUM_ID,
    "musicbrainz_albumstatus": K.MUSICBRAINZ_RELEASE_STATUS,
    "musicbrainz_albumtype": K.MUSICBRAINZ_RELEASE_TYPE,
    "musicbrainz_artistid": K.MUSICBRAINZ_ARTIST_ID,
    "musicbrainz_discid": K.MUSICBRAINZ_DISC_ID,
    "musicbrainz_originalalbumid": K.MUSICBRAINZ_ORIGINAL_ALBUM_ID,
    "musicbrainz_originalartistid": K.MUSICBRAINZ_ORIGINAL_ARTIST_ID,
    "musicbrainz_releasegroupid": K.MUSICBRAINZ_RELEASE_GROUP_ID,
    "musicbrainz_releasetrackid": K.MUSICBRAINZ_RELEASE_TRACK_ID,
    "musicbrainz_trackid": K.MUSICBRAINZ_TRACK_ID,
    "musicbrainz_trmid": K.MUSICBRAINZ_TRM_ID,
    "musicbrainz_workid": K.MUSICBRAINZ_WORK_ID,
    "original artist": K.ORIGINAL_ARTIST,
    "originalyear": ("year", K.ORIGINAL_RELEASE_YEAR),
    "publisher": K.LABEL,
    "record date": K.RECORDING_DATE,
    "record location": K.RECORDING_LOCATION,
    "related": K.URL,
    "replaygain_album_gain": K.REPLAYGAIN_ALBUM_GAIN,
    "replaygain_album_peak": K.REPLAYGAIN_ALBUM_PEAK,
    "replaygain_track_gain": K.REPLAYGAIN_TRACK_GAIN,
    "replaygain_track_peak": K.REPLAYGAIN_TRACK_PEAK,
    "subtitle": K.TRACK_SUBTITLE,
    "title": K.TRACK_TITLE,
    "titlesort": K.SORT_TRACK_TITLE,
    "track": ("pair", K.TRACK_NUMBER, K.TRACK_TOTAL),
    "work": K.WORK,
    "writer": K.WRITER,
    "year": ("year", K.RECORDING_YEAR),
}

# ---------------------------------------------------------------------------
# RIFF INFO chunk ids (embedded/riff.rs)
# ---------------------------------------------------------------------------

RIFF_MAP = {
    "ages": ("int", K.RATING),
    "cmnt": K.COMMENT,
    "comm": K.COMMENT,
    "dtim": K.RECORDING_TIME,
    "genr": K.GENRE,
    "iart": K.ARTIST,
    "icmt": K.COMMENT,
    "icnt": K.RELEASE_COUNTRY,
    "icop": K.COPYRIGHT,
    "icrd": K.RECORDING_DATE,
    "idit": K.RECORDING_DATE,
    "ienc": K.ENCODED_BY,
    "ieng": K.ENGINEER,
    "ifrm": ("int", K.TRACK_TOTAL),
    "ignr": K.GENRE,
    "ilng": K.LANGUAGE,
    "imed": K.MEDIA_FORMAT,
    "imus": K.COMPOSER,
    "inam": K.TRACK_TITLE,
    "iprd": K.ALBUM,
    "ipro": K.PRODUCER,
    "iprt": ("pair", K.TRACK_NUMBER, K.TRACK_TOTAL),
    "irtd": ("int", K.RATING),
    "isft": K.ENCODER,
    "isgn": K.GENRE,
    "isrf": K.MEDIA_FORMAT,
    "itch": K.ENCODED_BY,
    "itoc": K.CD_TOC,
    "itrk": ("pair", K.TRACK_NUMBER, K.TRACK_TOTAL),
    "iwri": K.WRITER,
    "lang": K.LANGUAGE,
    "prt1": ("pair", K.PART_NUMBER, K.PART_TOTAL),
    "prt2": ("int", K.PART_TOTAL),
    "titl": K.TRACK_TITLE,
    "torg": K.LABEL,
    "trck": ("pair", K.TRACK_NUMBER, K.TRACK_TOTAL),
    "tver": K.VERSION,
    "year": ("year", K.RECORDING_YEAR),
}

# ---------------------------------------------------------------------------
# ID3v2 text/url frame ids (id3v2/frames.rs frame map; v2.2 3-char ids are
# translated to their v2.3/4 equivalents by the reader before lookup)
# ---------------------------------------------------------------------------

ID3V2_MAP = {
    "talb": K.ALBUM,
    "tbpm": ("int", K.BPM),
    "tcat": K.PODCAST_CATEGORY,
    "tcmp": ("flag", K.COMPILATION_FLAG),
    "tcom": K.COMPOSER,
    "tcon": K.GENRE,
    "tcop": K.COPYRIGHT,
    "tdat": K.RECORDING_DATE,
    "tden": K.ENCODING_DATE,
    "tdes": K.PODCAST_DESCRIPTION,
    "tdly": None,
    "tdor": K.ORIGINAL_RELEASE_DATE,
    "tdrc": K.RECORDING_DATE,
    "tdrl": K.RELEASE_DATE,
    "tdtg": K.TAGGING_DATE,
    "tenc": K.ENCODED_BY,
    "text": K.LYRICIST,
    "tflt": None,
    "tgid": K.IDENT_PODCAST,
    "tipl": None,  # involved people list: reader splits the pairs
    "tit1": K.GROUPING,
    "tit2": K.TRACK_TITLE,
    "tit3": K.TRACK_SUBTITLE,
    "tkey": K.INITIAL_KEY,
    "tkwd": K.PODCAST_KEYWORDS,
    "tlan": K.LANGUAGE,
    "tlen": None,
    "tmcl": None,  # musician credits list: reader splits the pairs
    "tmed": K.MEDIA_FORMAT,
    "tmoo": K.MOOD,
    "toal": K.ORIGINAL_ALBUM,
    "tofn": K.ORIGINAL_FILE,
    "toly": K.ORIGINAL_LYRICIST,
    "tope": K.ORIGINAL_ARTIST,
    "tory": ("year", K.ORIGINAL_RELEASE_YEAR),
    "town": K.OWNER,
    "tpe1": K.ARTIST,
    "tpe2": K.ALBUM_ARTIST,
    "tpe3": K.CONDUCTOR,
    "tpe4": K.REMIXER,
    "tpos": ("pair", K.DISC_NUMBER, K.DISC_TOTAL),
    "tpro": K.PRODUCTION_COPYRIGHT,
    "tpub": K.LABEL,
    "trck": ("pair", K.TRACK_NUMBER, K.TRACK_TOTAL),
    "trda": K.RECORDING_DATE,
    "trsn": K.INTERNET_RADIO_NAME,
    "trso": K.INTERNET_RADIO_OWNER,
    "tsiz": None,
    "tsoa": K.SORT_ALBUM,
    "tsoc": K.SORT_COMPOSER,
    "tsop": K.SORT_ARTIST,
    "tso2": K.SORT_ALBUM_ARTIST,
    "tsot": K.SORT_TRACK_TITLE,
    "tsrc": K.IDENT_ISRC,
    "tsse": K.ENCODER_SETTINGS,
    "tsst": K.DISC_SUBTITLE,
    "tyer": ("year", K.RECORDING_YEAR),
    "wcom": K.URL_PURCHASE,
    "wcop": K.URL_COPYRIGHT,
    "wfed": K.URL_PODCAST,
    "woaf": K.URL_OFFICIAL,
    "woar": K.URL_ARTIST,
    "woas": K.URL_SOURCE,
    "wors": K.URL_INTERNET_RADIO,
    "wpay": K.URL_PAYMENT,
    "wpub": K.URL_LABEL,
}

# TXXX user-text frame descriptions reuse the Vorbis-style names plus a
# few iTunes/MusicBrainz spellings (frames.rs TXXX handling).
ID3V2_TXXX_MAP = dict(VORBIS_MAP)
ID3V2_TXXX_MAP.update({
    "musicbrainz album artist id": K.MUSICBRAINZ_ALBUM_ARTIST_ID,
    "musicbrainz album id": K.MUSICBRAINZ_ALBUM_ID,
    "musicbrainz album release country": K.RELEASE_COUNTRY,
    "musicbrainz album status": K.MUSICBRAINZ_RELEASE_STATUS,
    "musicbrainz album type": K.MUSICBRAINZ_RELEASE_TYPE,
    "musicbrainz artist id": K.MUSICBRAINZ_ARTIST_ID,
    "musicbrainz disc id": K.MUSICBRAINZ_DISC_ID,
    "musicbrainz original album id": K.MUSICBRAINZ_ORIGINAL_ALBUM_ID,
    "musicbrainz original artist id": K.MUSICBRAINZ_ORIGINAL_ARTIST_ID,
    "musicbrainz release group id": K.MUSICBRAINZ_RELEASE_GROUP_ID,
    "musicbrainz release track id": K.MUSICBRAINZ_RELEASE_TRACK_ID,
    "musicbrainz trm id": K.MUSICBRAINZ_TRM_ID,
    "musicbrainz work id": K.MUSICBRAINZ_WORK_ID,
})

# ---------------------------------------------------------------------------
# iTunes ilst atoms (isomp4 atoms/ilst.rs + utils/itunes.rs). Keys are the
# printable fourccs with (c) for the 0xA9 prefix; freeform '----' keys use
# the reverse-DNS name (itunes.rs map), looked up lowercased.
# ---------------------------------------------------------------------------

ITUNES_MAP = {
    "©alb": K.ALBUM,
    "©arg": K.ARRANGER,
    "©art": K.ARTIST,
    "©aut": K.AUTHOR,
    "©cmt": K.COMMENT,
    "©com": K.COMPOSER,
    "©con": K.CONDUCTOR,
    "©day": K.RECORDING_DATE,
    "©enc": K.ENCODED_BY,
    "©gen": K.GENRE,
    "©grp": K.GROUPING,
    "©isr": K.IDENT_ISRC,
    "©lab": K.LABEL,
    "©lal": K.URL_LABEL,
    "©lyr": K.LYRICS,
    "©mal": K.URL,
    "©nam": K.TRACK_TITLE,
    "©nrt": K.NARRATOR,
    "©ope": K.ORIGINAL_ARTIST,
    "©phg": K.PRODUCTION_COPYRIGHT,
    "©prd": K.PRODUCER,
    "©prl": K.URL_ARTIST,
    "©pub": K.LABEL,
    "©sol": K.SOLOIST,
    "©too": K.ENCODER,
    "©wrt": K.WRITER,
    "aart": K.ALBUM_ARTIST,
    "catg": K.PODCAST_CATEGORY,
    "cpil": ("flag", K.COMPILATION_FLAG),
    "cprt": K.COPYRIGHT,
    "desc": K.DESCRIPTION,
    "egid": K.IDENT_PODCAST,
    "keyw": K.PODCAST_KEYWORDS,
    "ldes": K.DESCRIPTION,
    "ownr": K.OWNER,
    "pcst": ("flag", K.PODCAST_FLAG),
    "purd": K.PURCHASE_DATE,
    "rate": ("int", K.RATING),
    "soaa": K.SORT_ALBUM_ARTIST,
    "soal": K.SORT_ALBUM,
    "soar": K.SORT_ARTIST,
    "soco": K.SORT_COMPOSER,
    "sonm": K.SORT_TRACK_TITLE,
    "tmpo": ("int", K.BPM),
    "tven": K.TV_EPISODE_TITLE,
    "tvnn": K.TV_NETWORK,
    "tvsh": K.TV_SERIES_TITLE,
}

# ---------------------------------------------------------------------------
# Matroska SimpleTag names (format-mkv tags.rs; the reference resolves some
# names per target type — this flat map covers the track-level defaults and
# extends the Vorbis-style names Matroska shares)
# ---------------------------------------------------------------------------

MKV_MAP = dict(VORBIS_MAP)
MKV_MAP.update({
    "accompaniment": K.ENSEMBLE,
    "actor": K.ACTOR,
    "arranger": K.ARRANGER,
    "content_type": K.CONTENT_TYPE,
    "date_digitized": K.DIGITIZED_DATE,
    "date_encoded": K.ENCODING_DATE,
    "date_purchased": K.PURCHASE_DATE,
    "date_recorded": K.RECORDING_DATE,
    "date_released": K.RELEASE_DATE,
    "date_tagged": K.TAGGING_DATE,
    "date_written": K.WRITTEN_DATE,
    "director": K.DIRECTOR,
    "edited_by": K.EDITED_BY,
    "imdb": K.IMDB_TITLE_ID,
    "initial_key": K.INITIAL_KEY,
    "keywords": K.KEYWORDS,
    "law_rating": K.CONTENT_RATING,
    "lead_performer": K.PERFORMER,
    "original_media_type": K.MEDIA_FORMAT,
    "part_number": ("int", K.PART_NUMBER),
    "period": K.PERIOD,
    "play_counter": ("int", K.PLAY_COUNTER),
    "production_studio": K.PRODUCTION_STUDIO,
    "purchase_owner": K.OWNER,
    "recording_location": K.RECORDING_LOCATION,
    "screenplay_by": K.SCREENPLAY_AUTHOR,
    "sort_with": K.SORT_TRACK_TITLE,
    "summary": K.SUMMARY,
    "synopsis": K.SYNOPSIS,
    "terms_of_use": K.TERMS_OF_USE,
    "thanks_to": K.THANKS,
    "tmdb": K.TMDB_MOVIE_ID,
    "total_parts": ("int", K.PART_TOTAL),
    "tuning": K.TUNING,
})

# -- Matroska tag Targets (format-mkv tags.rs:16-177, 328-507) -------------
#
# A Tags element's Targets assigns every SimpleTag a target level
# (10..70) and optionally an explicit target type name; the same tag name
# means different things at different levels (a level-50 TITLE is the
# album title, a level-30 TITLE the track title). Raw keys carry the
# target as a '<NAME>@' prefix (tags.rs get_target_path); the standard
# mapping switches on it.

# Default target type name by (level, is_video) — tags.rs:328-345.
_MKV_TARGET_AUDIO = {70: "COLLECTION", 60: "EDITION", 50: "ALBUM",
                     40: "PART", 30: "TRACK", 20: "SUBTRACK"}
_MKV_TARGET_VIDEO = {70: "COLLECTION", 60: "VOLUME", 50: "MOVIE",
                     40: "PART", 30: "CHAPTER", 20: "SCENE", 10: "SHOT"}


def mkv_target_name(value: int, is_video: bool) -> "Optional[str]":
    """Default target type name for a bare TargetTypeValue."""
    return (_MKV_TARGET_VIDEO if is_video else _MKV_TARGET_AUDIO).get(value)


# Full-path keys (target + tag) with fixed meanings — tags.rs:150-172.
_MKV_PATH_MAP = {
    "ALBUM@ARTIST": K.ALBUM_ARTIST,
    "ALBUM@ARTIST/SORT_WITH": K.SORT_ALBUM_ARTIST,
    # ReplayGain values stay strings ("-6.5 dB"), like the reference's
    # StandardTag::ReplayGain*(value) and the Vorbis-comment map.
    "ALBUM@REPLAYGAIN_GAIN": K.REPLAYGAIN_ALBUM_GAIN,
    "ALBUM@REPLAYGAIN_PEAK": K.REPLAYGAIN_ALBUM_PEAK,
    "TRACK@REPLAYGAIN_GAIN": K.REPLAYGAIN_TRACK_GAIN,
    "SONG@REPLAYGAIN_GAIN": K.REPLAYGAIN_TRACK_GAIN,
    "TRACK@REPLAYGAIN_PEAK": K.REPLAYGAIN_TRACK_PEAK,
    "SONG@REPLAYGAIN_PEAK": K.REPLAYGAIN_TRACK_PEAK,
}

# TITLE / TITLE/SORT_WITH / ORIGINAL/TITLE by target name (tags.rs:438-505).
_MKV_TITLE_MAP = {
    "COLLECTION": (K.COLLECTION_TITLE, K.SORT_COLLECTION_TITLE, None),
    "EDITION": (K.EDITION_TITLE, K.SORT_EDITION_TITLE, None),
    "VOLUME": (K.VOLUME_TITLE, K.SORT_VOLUME_TITLE, None),
    "OPUS": (K.OPUS, None, None),
    "SEASON": (K.TV_SEASON_TITLE, K.SORT_TV_SEASON_TITLE, None),
    "ALBUM": (K.ALBUM, K.SORT_ALBUM, K.ORIGINAL_ALBUM),
    "MOVIE": (K.MOVIE_TITLE, K.SORT_MOVIE_TITLE, None),
    "EPISODE": (K.TV_EPISODE_TITLE, K.SORT_TV_EPISODE_TITLE, None),
    "PART": (K.PART_TITLE, K.SORT_PART_TITLE, None),
    "TRACK": (K.TRACK_TITLE, K.SORT_TRACK_TITLE, None),
    "SONG": (K.TRACK_TITLE, K.SORT_TRACK_TITLE, None),
    "CHAPTER": (K.CHAPTER_TITLE, None, None),
    "MOVEMENT": (K.MOVEMENT_NAME, K.MOVEMENT_NAME, K.MOVEMENT_NAME),
}

_MKV_SUBTITLE_MAP = {"PART": K.DISC_SUBTITLE, "SESSION": K.DISC_SUBTITLE,
                     "TRACK": K.TRACK_SUBTITLE}

# PART_NUMBER counts items of the tag's own target (tags.rs:404-427).
_MKV_PART_NUMBER_MAP = {
    "VOLUME": K.VOLUME_NUMBER, "OPUS": K.OPUS_NUMBER,
    "SEASON": K.TV_SEASON_NUMBER, "EPISODE": K.TV_EPISODE_NUMBER,
    "PART": K.DISC_NUMBER, "SESSION": K.DISC_NUMBER,
    "TRACK": K.TRACK_NUMBER, "SONG": K.TRACK_NUMBER,
    "MOVEMENT": K.MOVEMENT_NUMBER,
}

# TOTAL_PARTS counts items of the NEXT LOWER target level, so it maps via
# the previous (lower) target's name (tags.rs:347-402).
_MKV_TOTAL_PARTS_MAP = {
    "VOLUME": K.VOLUME_TOTAL, "SEASON": K.TV_SEASON_TOTAL,
    "EPISODE": K.TV_EPISODE_TOTAL,
    "PART": K.DISC_TOTAL, "SESSION": K.DISC_TOTAL,
    "TRACK": K.TRACK_TOTAL, "SONG": K.TRACK_TOTAL,
    "MOVEMENT": K.MOVEMENT_TOTAL,
}

_MKV_ORIGINAL_MAP = {
    "ORIGINAL/ARTIST": K.ORIGINAL_ARTIST,
    "ORIGINAL/LYRICIST": K.ORIGINAL_LYRICIST,
    "ORIGINAL/WRITTEN_BY": K.ORIGINAL_WRITER,
}

_MKV_SORT_MAP = {
    "ARTIST/SORT_WITH": K.SORT_ARTIST,
    "COMPOSER/SORT_WITH": K.SORT_COMPOSER,
}


def map_mkv_tag(path: str, tag: str, value: Any, target_name: str,
                lower_name: "Optional[str]") -> List[RawTag]:
    """Map one target-scoped Matroska tag to 1-2 RawTags.

    ``path`` is the full raw key ('<TARGET>@<TAG>' or bare), ``tag`` the
    tag name without the target prefix, ``target_name`` the effective
    target type name ('' when untargeted) and ``lower_name`` the target
    name of the previously processed (lower-level) tag element in the
    same scope — TOTAL_PARTS counts the items of that lower level."""
    ent = _MKV_PATH_MAP.get(path)
    tag_u = tag.upper()
    if ent is None:
        if tag_u == "TITLE" or tag_u == "ORIGINAL/TITLE":
            t = _MKV_TITLE_MAP.get(target_name)
            ent = (t[0] if tag_u == "TITLE" else t[2]) if t else None
        elif tag_u == "TITLE/SORT_WITH":
            t = _MKV_TITLE_MAP.get(target_name)
            ent = t[1] if t else None
        elif tag_u == "SUBTITLE":
            ent = _MKV_SUBTITLE_MAP.get(target_name)
        elif tag_u == "PART_NUMBER":
            k = _MKV_PART_NUMBER_MAP.get(target_name)
            ent = ("int", k) if k else None
        elif tag_u == "TOTAL_PARTS":
            k = _MKV_TOTAL_PARTS_MAP.get(lower_name or "")
            ent = ("int", k) if k else None
        elif tag_u in _MKV_ORIGINAL_MAP:
            ent = _MKV_ORIGINAL_MAP[tag_u]
        elif tag_u in _MKV_SORT_MAP:
            ent = _MKV_SORT_MAP[tag_u]
    if ent is None:
        # Level-sensitive names under an *unknown* target stay unmapped
        # (tags.rs returns None there); with no target at all the legacy
        # flat map applies, so untargeted files keep working.
        if target_name and tag_u in ("TITLE", "SUBTITLE", "PART_NUMBER",
                                     "TOTAL_PARTS", "TITLE/SORT_WITH"):
            return [RawTag(path, value)]
        out = map_raw(tag, value, MKV_MAP)
        for t in out:
            t.key = path
        return out
    out = map_raw(tag, value, {tag.lower(): ent})
    for t in out:
        t.key = path
    return out


# Freeform '----' atom names (utils/itunes.rs:1-89), keyed by the mean:name
# tail lowercased.
ITUNES_FREEFORM_MAP = {
    "com.apple.itunes:acoustid fingerprint": K.ACOUSTID_FINGERPRINT,
    "com.apple.itunes:acoustid id": K.ACOUSTID_ID,
    "com.apple.itunes:asin": K.IDENT_ASIN,
    "com.apple.itunes:barcode": K.IDENT_BARCODE,
    "com.apple.itunes:catalognumber": K.IDENT_CATALOG_NUMBER,
    "com.apple.itunes:conductor": K.CONDUCTOR,
    "com.apple.itunes:discsubtitle": K.DISC_SUBTITLE,
    "com.apple.itunes:djmixer": K.MIX_DJ,
    "com.apple.itunes:engineer": K.ENGINEER,
    "com.apple.itunes:isrc": K.IDENT_ISRC,
    "com.apple.itunes:label": K.LABEL,
    "com.apple.itunes:language": K.LANGUAGE,
    "com.apple.itunes:license": K.LICENSE,
    "com.apple.itunes:lyricist": K.LYRICIST,
    "com.apple.itunes:media": K.MEDIA_FORMAT,
    "com.apple.itunes:mixer": K.MIX_ENGINEER,
    "com.apple.itunes:mood": K.MOOD,
    "com.apple.itunes:musicbrainz album artist id": K.MUSICBRAINZ_ALBUM_ARTIST_ID,
    "com.apple.itunes:musicbrainz album id": K.MUSICBRAINZ_ALBUM_ID,
    "com.apple.itunes:musicbrainz album release country": K.RELEASE_COUNTRY,
    "com.apple.itunes:musicbrainz album status": K.MUSICBRAINZ_RELEASE_STATUS,
    "com.apple.itunes:musicbrainz album type": K.MUSICBRAINZ_RELEASE_TYPE,
    "com.apple.itunes:musicbrainz artist id": K.MUSICBRAINZ_ARTIST_ID,
    "com.apple.itunes:musicbrainz disc id": K.MUSICBRAINZ_DISC_ID,
    "com.apple.itunes:musicbrainz original album id": K.MUSICBRAINZ_ORIGINAL_ALBUM_ID,
    "com.apple.itunes:musicbrainz original artist id": K.MUSICBRAINZ_ORIGINAL_ARTIST_ID,
    "com.apple.itunes:musicbrainz release group id": K.MUSICBRAINZ_RELEASE_GROUP_ID,
    "com.apple.itunes:musicbrainz release track id": K.MUSICBRAINZ_RELEASE_TRACK_ID,
    "com.apple.itunes:musicbrainz trm id": K.MUSICBRAINZ_TRM_ID,
    "com.apple.itunes:musicbrainz work id": K.MUSICBRAINZ_WORK_ID,
    "com.apple.itunes:remixer": K.REMIXER,
    "com.apple.itunes:replaygain_album_gain": K.REPLAYGAIN_ALBUM_GAIN,
    "com.apple.itunes:replaygain_album_peak": K.REPLAYGAIN_ALBUM_PEAK,
    "com.apple.itunes:replaygain_track_gain": K.REPLAYGAIN_TRACK_GAIN,
    "com.apple.itunes:replaygain_track_peak": K.REPLAYGAIN_TRACK_PEAK,
    "com.apple.itunes:script": K.SCRIPT,
    "com.apple.itunes:subtitle": K.TRACK_SUBTITLE,
}
