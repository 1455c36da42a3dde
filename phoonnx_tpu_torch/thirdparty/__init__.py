"""Bundled G2P/diacritization components (rebuilds of phoonnx/thirdparty).

Pure-Python host-side text processing: ARPA/Buckwalter/IPA mappings, Korean
and Chinese rule engines, Arabic G2P, plus JAX-backed diacritizer models.
"""
