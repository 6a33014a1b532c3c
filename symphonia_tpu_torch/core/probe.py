"""Container/metadata discovery: the Probe.

Analog of symphonia-core/src/formats/probe.rs: registered format and
metadata descriptors declare start-of-stream *markers* (2-16 byte prefixes,
probe.rs:680) and an optional ``score`` over a bounded context window
(probe.rs:210,723-749). Probing scans bytes up to ``max_probe_depth``
(default 1 MiB, probe.rs:287-308), consuming leading metadata (ID3v2 before
MP3/FLAC) along the way, and — for seekable sources — checks the
end-anchored trailing metadata readers (ID3v1 @ -128, APE @ -32,
probe.rs:90-102,475-544).

Instead of the reference's 2 KiB bloom filter over 2-byte prefixes
(probe.rs:36-88) a dict keyed on the first two bytes serves the same
O(1)-per-byte rejection role.
"""

from __future__ import annotations

import logging

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .errors import EndOfStream, Unsupported
from .formats import FormatOptions, FormatReader
from .meta import MetadataLog, MetadataOptions, MetadataRevision


@dataclass
class Descriptor:
    """A probeable format or metadata reader registration (probe.rs:224,239).

    ``markers``: byte prefixes identifying the stream start. ``score``:
    optional fn(context: bytes) -> int in [0, 255] (0 rejects); used to
    disambiguate weak markers (e.g. MPEG audio sync). ``factory``: for
    formats, fn(mss, FormatOptions) -> FormatReader; for metadata,
    fn() -> MetadataReader.
    """

    name: str
    markers: List[bytes]
    factory: Callable
    score: Optional[Callable[[bytes], int]] = None
    tier: int = 1  # common.rs:54 Tier
    is_metadata: bool = False
    # Trailing metadata: (offset_from_end, marker) anchor, e.g. (-128, b'TAG')
    trailing_anchor: Optional[Tuple[int, bytes]] = None


@dataclass
class ProbeResult:
    format: FormatReader
    metadata: MetadataLog


class Hint:
    """Caller-supplied probing hints (extension / MIME)."""

    def __init__(self):
        self.extension: Optional[str] = None
        self.mime_type: Optional[str] = None

    def with_extension(self, ext: str) -> "Hint":
        self.extension = ext.lower().lstrip(".")
        return self


@dataclass
class ProbeOptions:
    """Probe depth caps (probe.rs:287)."""

    max_probe_depth: int = 1 << 20  # 1 MiB
    score_context_len: int = 16 * 1024


logger = logging.getLogger("symphonia_tpu.probe")


class Probe:
    """The registry-driven prober (probe.rs:313)."""

    def __init__(self, options: Optional[ProbeOptions] = None):
        self.options = options or ProbeOptions()
        self._descriptors: List[Descriptor] = []
        # first-two-bytes -> descriptors (bloom-filter analog, probe.rs:36-88)
        self._prefix2: Dict[bytes, List[Descriptor]] = {}

    def register(self, desc: Descriptor) -> None:
        self._descriptors.append(desc)
        for m in desc.markers:
            if len(m) < 2:
                raise ValueError("markers must be >= 2 bytes")
            self._prefix2.setdefault(bytes(m[:2]), []).append(desc)

    def register_all(self, descs: List[Descriptor]) -> None:
        for d in descs:
            self.register(d)

    # -- probing -----------------------------------------------------------

    def probe(
        self,
        mss,
        hint: Optional[Hint] = None,
        fmt_opts: Optional[FormatOptions] = None,
        meta_opts: Optional[MetadataOptions] = None,
    ) -> ProbeResult:
        """Identify the container and return a FormatReader (probe.rs:429).

        Leading metadata (e.g. ID3v2) is consumed into the returned
        MetadataLog before the container is found; trailing metadata of
        seekable sources is collected first (probe.rs:475-544).
        """
        fmt_opts = fmt_opts or FormatOptions()
        meta_opts = meta_opts or MetadataOptions()
        log = MetadataLog()

        if mss.is_seekable():
            self._probe_trailing(mss, meta_opts, log)

        scanned = 0
        while scanned <= self.options.max_probe_depth:
            window = mss.peek_bytes(16)
            if len(window) < 2:
                raise Unsupported("unsupported format (eof while probing)")
            candidates = self._prefix2.get(window[:2], ())
            best: Optional[Tuple[int, Descriptor]] = None
            for desc in sorted(candidates, key=lambda d: d.tier):
                if desc.trailing_anchor is not None:
                    continue  # end-anchored readers never match leading

                if not any(window.startswith(m[: len(window)]) for m in desc.markers):
                    continue
                score = 255
                if desc.score is not None:
                    ctx = mss.peek_bytes(self.options.score_context_len)
                    score = desc.score(ctx)
                logger.debug("probe: %s scored %d at offset %d",
                             desc.name, score, scanned)
                if score and (best is None or score > best[0]):
                    best = (score, desc)
                    if score >= 255:
                        break
            if best is not None:
                desc = best[1]
                if desc.is_metadata:
                    reader = desc.factory()
                    rev = reader.read_all(mss)
                    if rev is not None:
                        log.push(rev)
                    continue  # resume scanning after the metadata block
                fmt = desc.factory(mss, self._with_external(fmt_opts, log))
                return ProbeResult(format=fmt, metadata=log)
            mss.ignore_bytes(1)
            scanned += 1
        raise Unsupported("unsupported format (probe depth exceeded)")

    @staticmethod
    def _with_external(fmt_opts: FormatOptions, log: MetadataLog) -> FormatOptions:
        """Hand probe-consumed metadata to the reader via
        ``FormatOptions.external_data`` (probe.rs:644-659): revisions are
        pushed into the external log, and chapters found in a revision
        (ID3v2 CHAP/CTOC) become the external chapters when none are set.
        The caller's options object is not mutated."""
        if log.is_empty():
            return fmt_opts
        import dataclasses

        from .formats import ExternalFormatData
        from .meta import ChapterGroup

        ext = fmt_opts.external_data
        merged = MetadataLog()
        if ext.metadata is not None:
            for rev in ext.metadata:
                merged.push(rev)
        chapters = ext.chapters
        for rev in log:
            merged.push(rev)
            rev_chapters = getattr(rev, "_chapters", None)
            if rev_chapters and chapters is None:
                chapters = ChapterGroup(items=list(rev_chapters))
        return dataclasses.replace(
            fmt_opts,
            external_data=ExternalFormatData(metadata=merged, chapters=chapters),
        )

    def _probe_trailing(self, mss, meta_opts: MetadataOptions, log: MetadataLog) -> None:
        """Check end-of-stream metadata anchors (probe.rs:475-544)."""
        total = mss.byte_len()
        if total is None:
            return
        start = mss.pos()
        for desc in self._descriptors:
            if desc.trailing_anchor is None:
                continue
            off, marker = desc.trailing_anchor
            pos = total + off
            if pos < 0:
                continue
            try:
                mss.seek(pos)
                if mss.peek_bytes(len(marker)) == marker:
                    reader = desc.factory()
                    rev = reader.read_all(mss)
                    if rev is not None:
                        log.push(rev)
            except Exception:
                pass
        mss.seek(start)
