"""The control of the serving cells' comparison.

The control is the reference put in the program's place and computed in
the nearest precision below the configuration's float32: TF32 allowed in
cuBLAS and cuDNN. :func:`readings` draws the weights and the texts of a
seed as a run does, takes the run's sample of requests (the closed
loop's: among the first bodies, the longest with them) and judges the
control's WAVs as a run judges the served ones.
"""

from harness import serve, traffic, weights
from reference import compare, frontend
from reference import vits as ref


def readings(cell, seed: int, requests: int, device) -> dict:
    cfg, mix = cell.config, cell.traffic
    w = ref.Weights(weights.make(weights.layout(cfg), seed, device))
    texts = traffic.lj_texts(mix, seed)
    ids = [frontend.text_to_ids(t, serve.id_map(cfg)) for t in texts]
    scale = serve.length_scale(w, cfg, ids[:mix["calibration_texts"]],
                               mix["mean_duration"])
    first = min(len(ids), mix["sample"].get("among_first", len(ids)))
    longest = max(range(first), key=lambda i: len(ids[i]))
    gaps, wrong = [], 0
    for i in traffic.sample(first, requests, seed, longest):
        pcm = compare.control_pcm(w, cfg, ids[i], scale)
        v = compare.judge(w, cfg, ids[i], scale, pcm)
        if v.frames_ok:
            gaps.append(v.gap_lsb)
        else:
            wrong += 1
    return {"seed": seed, "wav_gap_lsb": max(gaps) if gaps else None,
            "gaps": gaps, "wrong_length": wrong}
