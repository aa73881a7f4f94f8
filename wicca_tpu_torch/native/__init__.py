"""Host-side native components of the port (C++ built with g++ at first
use, bound with ctypes): the entropy coders of the ``.wct`` container."""
