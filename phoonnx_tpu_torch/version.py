"""phoonnx_tpu version.

Alpha-suffix scheme matches the reference (phoonnx/version.py): a
non-zero VERSION_ALPHA marks a prerelease (`0.1.0a3`), bumped by the
release workflow on every merge to dev and zeroed for stable releases.
"""

# START_VERSION_BLOCK
VERSION_MAJOR = 0
VERSION_MINOR = 1
VERSION_BUILD = 0
VERSION_ALPHA = 0
# END_VERSION_BLOCK

VERSION_STR = f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_BUILD}"
if VERSION_ALPHA:
    VERSION_STR += f"a{VERSION_ALPHA}"
__version__ = VERSION_STR
