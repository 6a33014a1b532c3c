"""ID3v1/v1.1 metadata reader.

Analog of symphonia-metadata/src/id3v1.rs (+ utils/id3v1.rs genre table):
the fixed 128-byte trailing tag anchored at EOF-128 (probe.rs:488 trailing
anchors).
"""

from __future__ import annotations

from typing import Optional

from ..core.errors import DecodeError
from ..core.meta import MetadataReader, MetadataRevision, RawTag, StandardTagKey as K
from ..core.probe import Descriptor

ID3V1_MARKER = b"TAG"

# ID3v1 genre list (utils/id3v1.rs:213): 80 standard + Winamp extensions.
GENRES = [
    "Blues", "Classic Rock", "Country", "Dance", "Disco", "Funk", "Grunge",
    "Hip-Hop", "Jazz", "Metal", "New Age", "Oldies", "Other", "Pop", "R&B",
    "Rap", "Reggae", "Rock", "Techno", "Industrial", "Alternative", "Ska",
    "Death Metal", "Pranks", "Soundtrack", "Euro-Techno", "Ambient",
    "Trip-Hop", "Vocal", "Jazz+Funk", "Fusion", "Trance", "Classical",
    "Instrumental", "Acid", "House", "Game", "Sound Clip", "Gospel",
    "Noise", "Alternative Rock", "Bass", "Soul", "Punk", "Space",
    "Meditative", "Instrumental Pop", "Instrumental Rock", "Ethnic",
    "Gothic", "Darkwave", "Techno-Industrial", "Electronic", "Pop-Folk",
    "Eurodance", "Dream", "Southern Rock", "Comedy", "Cult", "Gangsta",
    "Top 40", "Christian Rap", "Pop/Funk", "Jungle", "Native American",
    "Cabaret", "New Wave", "Psychedelic", "Rave", "Showtunes", "Trailer",
    "Lo-Fi", "Tribal", "Acid Punk", "Acid Jazz", "Polka", "Retro",
    "Musical", "Rock & Roll", "Hard Rock", "Folk", "Folk-Rock",
    "National Folk", "Swing", "Fast Fusion", "Bebop", "Latin", "Revival",
    "Celtic", "Bluegrass", "Avantgarde", "Gothic Rock", "Progressive Rock",
    "Psychedelic Rock", "Symphonic Rock", "Slow Rock", "Big Band",
    "Chorus", "Easy Listening", "Acoustic", "Humour", "Speech", "Chanson",
    "Opera", "Chamber Music", "Sonata", "Symphony", "Booty Bass", "Primus",
    "Porn Groove", "Satire", "Slow Jam", "Club", "Tango", "Samba",
    "Folklore", "Ballad", "Power Ballad", "Rhythmic Soul", "Freestyle",
    "Duet", "Punk Rock", "Drum Solo", "A Cappella", "Euro-House",
    "Dance Hall",
    # 126-147: Winamp extensions (utils/id3v1.rs).
    "Goa", "Drum & Bass", "Club-House", "Hardcore Techno", "Terror",
    "Indie", "BritPop",
    # Genre 133's original name was an offensive term; Winamp 5.63+
    # renamed it (the reference follows suit).
    "Afro-Punk",
    "Polsk Punk", "Beat", "Christian Gangsta Rap", "Heavy Metal",
    "Black Metal", "Crossover", "Contemporary Christian",
    "Christian rock", "Merengue", "Salsa", "Thrash Metal", "Anime",
    "Jpop", "Synthpop",
    # 148-191: Winamp 5 extensions.
    "Abstract", "Art Rock", "Baroque", "Bhangra", "Big beat",
    "Breakbeat", "Chillout", "Downtempo", "Dub", "EBM", "Eclectic",
    "Electro", "Electroclash", "Emo", "Experimental", "Garage",
    "Global", "IDM", "Illbient", "Industro-Goth", "Jam Band",
    "Krautrock", "Leftfield", "Lounge", "Math Rock", "New Romantic",
    "Nu-Breakz", "Post-Punk", "Post-Rock", "Psytrance", "Shoegaze",
    "Space Rock", "Trop Rock", "World Music", "Neoclassical",
    "Audiobook", "Audio theatre", "Neue Deutsche Welle", "Podcast",
    "Indie-Rock", "G-Funk", "Dubstep", "Garage Rock", "Psybient",
]


def _text(b: bytes) -> Optional[str]:
    s = b.split(b"\x00")[0].decode("latin-1", "replace").strip()
    return s or None


class Id3v1Reader(MetadataReader):
    """ID3v1 tag reader (id3v1.rs:154)."""

    def read_all(self, reader) -> Optional[MetadataRevision]:
        tag = reader.read_bytes(128)
        if tag[:3] != ID3V1_MARKER:
            raise DecodeError("not an ID3v1 tag")
        rev = MetadataRevision()

        def add(key, val, std):
            if val:
                rev.tags.append(RawTag(key, val, std))

        add("title", _text(tag[3:33]), K.TRACK_TITLE)
        add("artist", _text(tag[33:63]), K.ARTIST)
        add("album", _text(tag[63:93]), K.ALBUM)
        add("year", _text(tag[93:97]), K.DATE)
        # v1.1: comment[28] == 0 and comment[29] != 0 -> track number.
        if tag[125] == 0 and tag[126] != 0:
            add("comment", _text(tag[97:125]), K.COMMENT)
            add("track", str(tag[126]), K.TRACK_NUMBER)
        else:
            add("comment", _text(tag[97:127]), K.COMMENT)
        genre = tag[127]
        if genre < len(GENRES):
            add("genre", GENRES[genre], K.GENRE)
        return rev


DESCRIPTOR = Descriptor(
    name="id3v1",
    markers=[ID3V1_MARKER],
    factory=Id3v1Reader,
    is_metadata=True,
    trailing_anchor=(-128, ID3V1_MARKER),
)
