"""MVSNet ``pair.txt`` parsing and neighbour selection.

``pair.txt``: the view count, then for each view its id and a line
``n id_1 score_1 ... id_n score_n``. When a view's list runs short,
:func:`backfill_neighbors` walks its neighbours' own lists breadth-first.
"""

from __future__ import annotations

from typing import Dict, List


def load_pair(path) -> Dict:
    """pair.txt -> {img_id: {'id', 'index', 'pair', 'score'}, 'id_list': [...]}."""
    with open(path) as f:
        lines = f.readlines()
    n_cam = int(lines[0])
    pairs: Dict = {}
    img_ids: List[int] = []
    for i in range(1, 1 + 2 * n_cam, 2):
        img_id = int(lines[i].strip())
        tokens = lines[i + 1].strip().split(" ")
        n_pair = int(tokens[0])
        pair = [int(tokens[j]) for j in range(1, 1 + 2 * n_pair, 2)]
        score = [float(tokens[j + 1]) for j in range(1, 1 + 2 * n_pair, 2)]
        img_ids.append(img_id)
        pairs[img_id] = {"id": img_id, "index": i // 2, "pair": pair,
                         "score": score}
    pairs["id_list"] = img_ids
    return pairs


def backfill_neighbors(pair_list: Dict, ref_id: int,
                       num_frames: int) -> List[int]:
    """The top ``num_frames`` neighbours; when the list is short, the
    goal-th best of each neighbour's own list, breadth-first, until full."""
    base = pair_list[ref_id]["pair"]
    if len(base) >= num_frames:
        return list(base[:num_frames])
    neighbors = list(base)
    head = 0
    goal = 0
    while len(neighbors) < num_frames:
        if head < len(neighbors):
            cand_list = pair_list[neighbors[head]]["pair"]
            if len(cand_list) > goal:
                new_f = cand_list[goal]
            else:
                break
        else:
            head = 0
            goal += 1
            continue
        if new_f not in neighbors and new_f != ref_id:
            neighbors.append(new_f)
        head += 1
    return neighbors

