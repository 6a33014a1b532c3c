"""Stream builders for the port's tests and ``chip_smoke.py``: copies of the
repository's test encoders (``tests/flac_builder.py``, ``mp3_builder.py``,
``aac_builder.py``, ``vorbis_builder.py``, and the Layer I/II and Ogg page
builders of ``tests/test_layer12.py`` and ``tests/test_vorbis_ogg.py``)
that import only this package and read its ``data/``. Each gives the same
bytes as its original for the same arguments.
"""
