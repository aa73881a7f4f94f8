"""Host-side image validation and layout conversion."""
