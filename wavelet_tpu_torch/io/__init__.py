"""Host-side byte I/O: AMReX plotfiles (FAB format) and the compressed archive."""
