"""Host C++ code of the port, built with g++ at first use (``build.py``)."""
