"""ARPAbet -> IPA mapping (reference: phoonnx/thirdparty/arpa2ipa.py).

The lookup covers plain phones and all stress-digit variants (AH0/AH1/...).
Data lives in ``_arpa2ipa.json`` (interchange data shared with the
reference implementation).
"""

import json
import os
from typing import Dict

_DATA_PATH = os.path.join(os.path.dirname(__file__), "_arpa2ipa.json")

with open(_DATA_PATH, encoding="utf-8") as _f:
    arpa_to_ipa_lookup: Dict[str, str] = json.load(_f)


def arpa_to_ipa(arpa: str) -> str:
    """Space-separated ARPA phones -> space-separated IPA."""
    return " ".join(arpa_to_ipa_lookup[p] for p in arpa.split(" "))
