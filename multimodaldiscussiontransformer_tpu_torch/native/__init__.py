"""The C++ host helper (tree distances, Floyd-Warshall, spatial buckets),
built with g++ at first use and loaded with ctypes (``loader.py``)."""
