"""The optional C++ host fast path (``fastops``): n-gram hashing and fuzzy
ratios for the host rerank, CRC32 and the framed append for the WAL.

Counterpart of ``minivectordb_tpu/native``. ``fastops.cpp`` is built with g++
at first use (``build.py``) and loaded with ctypes (``fastops.py``); without
a compiler every caller takes its pure-Python path, with identical results.
"""
