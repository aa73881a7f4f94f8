"""Host-side native components of the port (C++ built with g++ at first
use, bound with ctypes): the entropy coders of the ``.wct`` container
(``rice``), the host Haar and 5/3 levels of the folder pipeline's host
routes (``idwt``), the strip-parallel PNG writer (``pngw``) and the host
side of the packed stream transfer (``pack``)."""

from wicca_tpu_torch.native.rice import native_available, rice_decode, rice_encode  # noqa: F401
