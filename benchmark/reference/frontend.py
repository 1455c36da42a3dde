"""Text to ids for a voice whose phonemes are its raw characters.

piper's ``phonemes_to_ids`` with its defaults: the BOS id, then each
character's id followed by the pad id, then the EOS id.
"""

from typing import Dict, List


def text_to_ids(text: str, id_map: Dict[str, int]) -> List[int]:
    ids = [id_map["^"], id_map["_"]]
    for ch in text:
        ids += [id_map[ch], id_map["_"]]
    return ids + [id_map["$"]]
