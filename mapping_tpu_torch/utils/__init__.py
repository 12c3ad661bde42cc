"""Host helpers: the repository's C++ libraries (cpp/) built with g++ and
bound with ctypes, and image decoding."""
