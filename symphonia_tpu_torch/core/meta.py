"""Metadata model: tags, visuals, chapters, revisions.

Analog of symphonia-core/src/meta.rs: ``StandardTag`` (meta.rs:184, ~200
variants — here a string-key namespace), ``RawTag``/``RawValue``
(meta.rs:508,405), ``Visual`` cover art (meta.rs:643), ``Chapter``
(meta.rs:666-703), the ``MetadataLog`` revision queue (meta.rs:847), and
``MetadataOptions`` DoS limits (meta.rs:105).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class StandardTagKey:
    """Well-known tag keys: the full ~200-variant namespace of the
    reference's StandardTag enum (meta.rs:184), as stable snake_case
    strings. Legacy aliases at the bottom keep earlier-round constant
    names working (same values)."""

    ACCURATE_RIP_COUNT = "accurate_rip_count"
    ACCURATE_RIP_COUNT_ALL_OFFSETS = "accurate_rip_count_all_offsets"
    ACCURATE_RIP_COUNT_WITH_OFFSET = "accurate_rip_count_with_offset"
    ACCURATE_RIP_CRC = "accurate_rip_crc"
    ACCURATE_RIP_DISC_ID = "accurate_rip_disc_id"
    ACCURATE_RIP_ID = "accurate_rip_id"
    ACCURATE_RIP_OFFSET = "accurate_rip_offset"
    ACCURATE_RIP_RESULT = "accurate_rip_result"
    ACCURATE_RIP_TOTAL = "accurate_rip_total"
    ACOUSTID_FINGERPRINT = "acoustid_fingerprint"
    ACOUSTID_ID = "acoustid_id"
    ACTOR = "actor"
    ALBUM = "album"
    ALBUM_ARTIST = "album_artist"
    ARRANGER = "arranger"
    ARTIST = "artist"
    ART_DIRECTOR = "art_director"
    ASSISTANT_DIRECTOR = "assistant_director"
    AUTHOR = "author"
    BPM = "bpm"
    CD_TOC = "cd_toc"
    CD_TRACK_INDEX = "cd_track_index"
    CHAPTER_TITLE = "chapter_title"
    CHOREGRAPHER = "choregrapher"
    CINEMATOGRAPHER = "cinematographer"
    COLLECTION_TITLE = "collection_title"
    COMMENT = "comment"
    COMPILATION_FLAG = "compilation"
    COMPOSER = "composer"
    CONDUCTOR = "conductor"
    CONTENT_ADVISORY = "content_advisory"
    CONTENT_RATING = "content_rating"
    CONTENT_TYPE = "content_type"
    COPRODUCER = "coproducer"
    COPYRIGHT = "copyright"
    COSTUME_DESIGNER = "costume_designer"
    CUE_TOOLS_DB_DISC_CONFIDENCE = "cue_tools_db_disc_confidence"
    CUE_TOOLS_DB_TRACK_CONFIDENCE = "cue_tools_db_track_confidence"
    DESCRIPTION = "description"
    DIGITIZED_DATE = "digitized_date"
    DIRECTOR = "director"
    DISC_NUMBER = "disc_number"
    DISC_SUBTITLE = "disc_subtitle"
    DISC_TOTAL = "disc_total"
    DISTRIBUTOR = "distributor"
    EDITED_BY = "edited_by"
    EDITION_TITLE = "edition_title"
    ENCODED_BY = "encoded_by"
    ENCODER = "encoder"
    ENCODER_SETTINGS = "encoder_settings"
    ENCODING_DATE = "encoding_date"
    ENGINEER = "engineer"
    ENSEMBLE = "ensemble"
    EXECUTIVE_PRODUCER = "executive_producer"
    GENRE = "genre"
    GROUPING = "grouping"
    IDENT_ASIN = "ident_asin"
    IDENT_BARCODE = "ident_barcode"
    IDENT_CATALOG_NUMBER = "ident_catalog_number"
    IDENT_EAN_UPN = "ident_ean_upn"
    IDENT_ISBN = "ident_isbn"
    IDENT_ISRC = "ident_isrc"
    IDENT_LCCN = "ident_lccn"
    IDENT_PN = "ident_pn"
    IDENT_PODCAST = "ident_podcast"
    IDENT_UPC = "ident_upc"
    IMDB_TITLE_ID = "imdb_title_id"
    INITIAL_KEY = "initial_key"
    INTERNET_RADIO_NAME = "internet_radio_name"
    INTERNET_RADIO_OWNER = "internet_radio_owner"
    KEYWORDS = "keywords"
    LABEL = "label"
    LABEL_CODE = "label_code"
    LANGUAGE = "language"
    LICENSE = "license"
    LYRICIST = "lyricist"
    LYRICS = "lyrics"
    MEASURE = "measure"
    MEDIA_FORMAT = "media_format"
    MIX_DJ = "mix_dj"
    MIX_ENGINEER = "mix_engineer"
    MOOD = "mood"
    MOVEMENT_NAME = "movement_name"
    MOVEMENT_NUMBER = "movement_number"
    MOVEMENT_TOTAL = "movement_total"
    MOVIE_TITLE = "movie_title"
    MP3GAIN_ALBUM_MIN_MAX = "mp3gain_album_min_max"
    MP3GAIN_MIN_MAX = "mp3gain_min_max"
    MP3GAIN_UNDO = "mp3gain_undo"
    MUSICBRAINZ_ALBUM_ARTIST_ID = "musicbrainz_album_artist_id"
    MUSICBRAINZ_ALBUM_ID = "musicbrainz_album_id"
    MUSICBRAINZ_ARTIST_ID = "musicbrainz_artist_id"
    MUSICBRAINZ_DISC_ID = "musicbrainz_disc_id"
    MUSICBRAINZ_GENRE_ID = "musicbrainz_genre_id"
    MUSICBRAINZ_LABEL_ID = "musicbrainz_label_id"
    MUSICBRAINZ_ORIGINAL_ALBUM_ID = "musicbrainz_original_album_id"
    MUSICBRAINZ_ORIGINAL_ARTIST_ID = "musicbrainz_original_artist_id"
    MUSICBRAINZ_RECORDING_ID = "musicbrainz_recording_id"
    MUSICBRAINZ_RELEASE_GROUP_ID = "musicbrainz_release_group_id"
    MUSICBRAINZ_RELEASE_STATUS = "musicbrainz_release_status"
    MUSICBRAINZ_RELEASE_TRACK_ID = "musicbrainz_release_track_id"
    MUSICBRAINZ_RELEASE_TYPE = "musicbrainz_release_type"
    MUSICBRAINZ_TRACK_ID = "musicbrainz_track_id"
    MUSICBRAINZ_TRM_ID = "musicbrainz_trm_id"
    MUSICBRAINZ_WORK_ID = "musicbrainz_work_id"
    NARRATOR = "narrator"
    OPUS = "opus"
    OPUS_NUMBER = "opus_number"
    ORIGINAL_ALBUM = "original_album"
    ORIGINAL_ARTIST = "original_artist"
    ORIGINAL_FILE = "original_file"
    ORIGINAL_LYRICIST = "original_lyricist"
    ORIGINAL_RECORDING_DATE = "original_recording_date"
    ORIGINAL_RECORDING_TIME = "original_recording_time"
    ORIGINAL_RECORDING_YEAR = "original_recording_year"
    ORIGINAL_RELEASE_DATE = "original_date"
    ORIGINAL_RELEASE_TIME = "original_release_time"
    ORIGINAL_RELEASE_YEAR = "original_release_year"
    ORIGINAL_WRITER = "original_writer"
    OWNER = "owner"
    PART = "part"
    PART_NUMBER = "part_number"
    PART_TITLE = "part_title"
    PART_TOTAL = "part_total"
    PERFORMER = "performer"
    PERIOD = "period"
    PLAY_COUNTER = "play_counter"
    PODCAST_CATEGORY = "podcast_category"
    PODCAST_DESCRIPTION = "podcast_description"
    PODCAST_FLAG = "podcast"
    PODCAST_KEYWORDS = "podcast_keywords"
    PRODUCER = "producer"
    PRODUCTION_COPYRIGHT = "production_copyright"
    PRODUCTION_DESIGNER = "production_designer"
    PRODUCTION_STUDIO = "production_studio"
    PURCHASE_DATE = "purchase_date"
    RATING = "rating"
    RECORDING_DATE = "date"
    RECORDING_LOCATION = "recording_location"
    RECORDING_TIME = "recording_time"
    RECORDING_YEAR = "recording_year"
    RELEASE_COUNTRY = "release_country"
    RELEASE_DATE = "release_date"
    RELEASE_TIME = "release_time"
    RELEASE_YEAR = "release_year"
    REMIXER = "remixer"
    REPLAYGAIN_ALBUM_GAIN = "replaygain_album_gain"
    REPLAYGAIN_ALBUM_PEAK = "replaygain_album_peak"
    REPLAYGAIN_ALBUM_RANGE = "replaygain_album_range"
    REPLAYGAIN_REFERENCE_LOUDNESS = "replaygain_reference_loudness"
    REPLAYGAIN_TRACK_GAIN = "replaygain_track_gain"
    REPLAYGAIN_TRACK_PEAK = "replaygain_track_peak"
    REPLAYGAIN_TRACK_RANGE = "replaygain_track_range"
    SCREENPLAY_AUTHOR = "screenplay_author"
    SCRIPT = "script"
    SOLOIST = "soloist"
    SORT_ALBUM = "sort_album"
    SORT_ALBUM_ARTIST = "sort_album_artist"
    SORT_ARTIST = "sort_artist"
    SORT_COLLECTION_TITLE = "sort_collection_title"
    SORT_COMPOSER = "sort_composer"
    SORT_EDITION_TITLE = "sort_edition_title"
    SORT_MOVIE_TITLE = "sort_movie_title"
    SORT_OPUS_TITLE = "sort_opus_title"
    SORT_PART_TITLE = "sort_part_title"
    SORT_TRACK_TITLE = "sort_track_title"
    SORT_TV_EPISODE_TITLE = "sort_tv_episode_title"
    SORT_TV_SEASON_TITLE = "sort_tv_season_title"
    SORT_TV_SERIES_TITLE = "sort_tv_series_title"
    SORT_VOLUME_TITLE = "sort_volume_title"
    SUBJECT = "subject"
    SUMMARY = "summary"
    SYNOPSIS = "synopsis"
    TAGGING_DATE = "tagging_date"
    TERMS_OF_USE = "terms_of_use"
    THANKS = "thanks"
    TMDB_MOVIE_ID = "tmdb_movie_id"
    TMDB_SERIES_ID = "tmdb_series_id"
    TRACK_NUMBER = "track_number"
    TRACK_SUBTITLE = "track_subtitle"
    TRACK_TITLE = "track_title"
    TRACK_TOTAL = "track_total"
    TUNING = "tuning"
    TVDB_EPISODE_ID = "tvdb_episode_id"
    TVDB_MOVIE_ID = "tvdb_movie_id"
    TVDB_SERIES_ID = "tvdb_series_id"
    TV_EPISODE_NUMBER = "tv_episode_number"
    TV_EPISODE_TITLE = "tv_episode_title"
    TV_EPISODE_TOTAL = "tv_episode_total"
    TV_NETWORK = "tv_network"
    TV_SEASON_NUMBER = "tv_season_number"
    TV_SEASON_TITLE = "tv_season_title"
    TV_SEASON_TOTAL = "tv_season_total"
    TV_SERIES_TITLE = "tv_series_title"
    URL = "url"
    URL_ARTIST = "url_artist"
    URL_COPYRIGHT = "url_copyright"
    URL_INTERNET_RADIO = "url_internet_radio"
    URL_LABEL = "url_label"
    URL_OFFICIAL = "url_official"
    URL_PAYMENT = "url_payment"
    URL_PODCAST = "url_podcast"
    URL_PURCHASE = "url_purchase"
    URL_SOURCE = "url_source"
    VERSION = "version"
    VOLUME_NUMBER = "volume_number"
    VOLUME_TITLE = "volume_title"
    VOLUME_TOTAL = "volume_total"
    WORK = "work"
    WRITER = "writer"
    WRITTEN_DATE = "written_date"

    # -- legacy aliases (earlier-round names; same string values) ---------
    DATE = RECORDING_DATE
    COMPILATION = COMPILATION_FLAG
    ORIGINAL_DATE = ORIGINAL_RELEASE_DATE
    PODCAST = PODCAST_FLAG


@dataclass
class RawTag:
    """An unmapped container tag (meta.rs:508): raw key + value, with the
    mapped standard key when known. ``sub_fields`` carries auxiliary
    per-tag qualifiers (meta.rs RawTagSubField), e.g. an ID3v2.3/2.4
    frame's group id or encryption method id."""

    key: str
    value: Any
    std_key: Optional[str] = None
    sub_fields: Optional[Dict[str, Any]] = None


@dataclass
class Visual:
    """Embedded artwork (meta.rs:643)."""

    media_type: Optional[str]
    data: bytes
    usage: Optional[str] = None  # e.g. 'front_cover'
    dimensions: Optional[tuple] = None
    tags: List[RawTag] = field(default_factory=list)


@dataclass
class Attachment:
    """An attached file, e.g. from Matroska Attachments (meta.rs attachment
    types; mkv demuxer.rs:583-590)."""

    name: Optional[str]
    media_type: Optional[str]
    data: bytes
    description: Optional[str] = None


def sniff_image(data: bytes) -> Optional[str]:
    """Best-effort image MIME sniffing (utils/images.rs:295 analog)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "image/png"
    if data[:2] == b"\xff\xd8":
        return "image/jpeg"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "image/gif"
    if data[:2] == b"BM":
        return "image/bmp"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "image/webp"
    return None


@dataclass
class Chapter:
    """A chapter marker (meta.rs:666)."""

    start_time: float
    end_time: Optional[float] = None
    title: Optional[str] = None
    tags: List[RawTag] = field(default_factory=list)


@dataclass
class ChapterGroup:
    items: List[Chapter] = field(default_factory=list)
    title: Optional[str] = None


@dataclass
class MetadataRevision:
    """One complete metadata snapshot (meta.rs:727)."""

    tags: List[RawTag] = field(default_factory=list)
    visuals: List[Visual] = field(default_factory=list)
    vendor: Optional[str] = None
    # Tags scoped to a single track by the container (e.g. Matroska tag
    # Targets carrying TagTrackUID — format-mkv tags.rs / segment.rs
    # PerTrackMetadataBuilder), keyed by the container's track UID.
    track_tags: Dict[int, List[RawTag]] = field(default_factory=dict)

    def get(self, std_key: str) -> Optional[Any]:
        for t in self.tags:
            if t.std_key == std_key:
                return t.value
        return None


class MetadataLog:
    """Queue of metadata revisions (meta.rs:847): newer revisions supersede
    older ones; consumers pop outdated revisions as they go."""

    def __init__(self):
        self._revisions: List[MetadataRevision] = []

    def push(self, rev: MetadataRevision) -> None:
        self._revisions.append(rev)

    def current(self) -> Optional[MetadataRevision]:
        return self._revisions[-1] if self._revisions else None

    def skip_to_latest(self) -> Optional[MetadataRevision]:
        if not self._revisions:
            return None
        latest = self._revisions[-1]
        self._revisions = [latest]
        return latest

    def is_empty(self) -> bool:
        return not self._revisions

    def __iter__(self):
        return iter(self._revisions)


@dataclass
class MetadataOptions:
    """DoS limits for metadata parsing (meta.rs:105)."""

    limit_metadata_bytes: int = 16 * 1024 * 1024
    limit_visual_bytes: int = 16 * 1024 * 1024


class MetadataReader:
    """Contract for standalone metadata readers (meta.rs:898): ID3v2, APE,
    ID3v1. Construct over a stream, ``read_all`` to a revision."""

    def __init__(self, options: Optional[MetadataOptions] = None):
        self.options = options or MetadataOptions()

    def read_all(self, reader) -> MetadataRevision:
        raise NotImplementedError
