"""Stream builders for the port's tests and ``chip_smoke.py``: copies of the
repository's test encoders (``tests/flac_builder.py``, ``mp3_builder.py``,
``aac_builder.py``, ``vorbis_builder.py``, ``alac_builder.py``, and the
Layer I/II, Ogg page, WAV, AIFF/CAF, ADPCM, Matroska and PCM-in-MP4
builders of ``tests/test_layer12.py``, ``test_vorbis_ogg.py``,
``test_wav_pcm.py``, ``test_aiff_caf.py``, ``test_adpcm.py``,
``test_mkv.py`` and ``test_mp4.py``) that import only this package and read
its ``data/``. Each gives the same bytes as its original for the same
arguments.
"""
