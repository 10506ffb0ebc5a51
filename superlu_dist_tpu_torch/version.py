"""Version info (analog of SRC/prec-independent/superlu_dist_version.c):
the port's own copy of the JAX package's ``version.py``, whose numbers it
carries."""

__version__ = "0.5.0"
VERSION_MAJOR = 0
VERSION_MINOR = 5
VERSION_PATCH = 0


def get_version_number():
    """Return (major, minor, patch) — analog of superlu_dist_GetVersionNumber."""
    return VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH
