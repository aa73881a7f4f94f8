"""Host-side native components of the port (C++ built with g++ at first
use, bound with ctypes): the entropy coders of the ``.wct`` container
(``rice``), the host Haar and 5/3 levels of the folder pipeline's host
routes (``idwt``) and the strip-parallel PNG writer (``pngw``)."""
