"""Binary BoW vocabulary: a hierarchical k-means tree over ORB descriptors
(PyTorch port of models/vocabulary.py; reference: DBoW2's
TemplatedVocabulary, Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h).

A k-branch, L-level tree of binary descriptors with TF-IDF weights
(:942-996) and L1 scoring (:1198-1203), stored as flat tables (children,
packed node descriptors, word ids). `transform` descends the tree for all
features at once on the tensor's device, in plain PyTorch: per level a
gather of each feature's k child descriptors, XOR, popcount, the first
minimum (:1218-1259 batched). The JAX package runs this descent in XLA,
not in a Pallas kernel, so it has no hand-written kernel here either. On
CUDA tensors the descent is one replay of a CUDA graph (`_descend_jit`,
utils/cuda_graph.py; the JAX package's jitted `_transform_device`) that
reads the vocabulary's device tables in place: they are part of the
graph's key, not inputs copied at each call. On CPU tensors it runs
eagerly.

Training (bitwise-majority k-means with k-means++ seeding, DBoW2's
meanValue) and the text / npz formats are numpy, as in the JAX package:
an offline step, like the reference's pre-trained ORBvoc.txt. The bundled
vocabulary is the JAX package's data file, read by path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.interop import resolve_device, to_device, to_host
from orb_slam2_commit_tpu_torch.utils import cuda_graph

N_WORDS_DEFAULT_K = 10
N_WORDS_DEFAULT_L = 6

DEFAULT_VOC_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "orb_slam2_commit_tpu", "data", "default_voc.npz")

_POPCOUNT_LUT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint16)


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    """Popcount over packed uint32 rows [..., 8] -> [...]."""
    b = x.view(np.uint8).reshape(x.shape[:-1] + (32,))
    return _POPCOUNT_LUT[b].sum(-1)


def _majority_descriptor(descs: np.ndarray) -> np.ndarray:
    """Bitwise-majority mean of packed descriptors (DBoW2 FORB::meanValue)."""
    bits = np.unpackbits(descs.view(np.uint8).reshape(descs.shape[0], 32), axis=-1)
    maj = (bits.sum(0) * 2 >= descs.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _hamming_to(centroids: np.ndarray, descs: np.ndarray) -> np.ndarray:
    """[n, c] distances, in chunks of at most 16 MB of XOR words."""
    n, c = descs.shape[0], centroids.shape[0]
    out = np.empty((n, c), np.uint16)
    chunk = max(1, (1 << 24) // max(c * 32, 1))
    for s in range(0, n, chunk):
        out[s: s + chunk] = _popcount_rows(descs[s: s + chunk, None, :] ^ centroids[None, :, :])
    return out


def _kmeans_binary(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-means with majority centroids -> (centroids, labels)."""
    n = descs.shape[0]
    k = min(k, n)
    first = rng.integers(n)                 # k-means++ seeding
    centroids = [descs[first]]
    d2 = _hamming_to(np.asarray(centroids), descs)[:, 0].astype(np.float64)
    for _ in range(1, k):
        nxt = rng.choice(n, p=d2 / max(d2.sum(), 1e-9))
        centroids.append(descs[nxt])
        d2 = np.minimum(d2, _hamming_to(descs[nxt][None], descs)[:, 0])
    centroids = np.stack(centroids)
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        new_labels = _hamming_to(centroids, descs).argmin(1)
        if (new_labels == labels).all():
            labels = new_labels
            break
        labels = new_labels
        for c in range(k):
            sel = labels == c
            if sel.any():
                centroids[c] = _majority_descriptor(descs[sel])
    return centroids, labels


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as its uint32 bits) -> int64. torch has
    no popcount and no uint32 arithmetic: the SWAR count runs on the int64
    value of the word."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 & 0xFFFFFFFF) >> 24


def _first_argmin(d: torch.Tensor) -> torch.Tensor:
    """Lowest index of each row's minimum (jnp.argmin's rule)."""
    cols = torch.arange(d.shape[-1], device=d.device)
    return torch.where(d == d.amin(dim=-1, keepdim=True), cols, d.shape[-1]).amin(dim=-1)


def _descend(desc: torch.Tensor, children: torch.Tensor, node_desc: torch.Tensor,
             word_id: torch.Tensor, levels: int, levels_up: int):
    """The tree descent for every descriptor at once, on desc's device:
    desc [N, 8] int32 -> (word ids [N], node ids at depth
    levels - levels_up [N]), int64.

    Per level: gather the k child descriptors of each feature's node, XOR
    and popcount against the feature, take the first minimum; a missing
    child (-1) gets distance 2^20, and a node with no child keeps the
    feature where it is (variable-depth trees)."""
    n = desc.shape[0]
    current = torch.zeros(n, dtype=torch.int64, device=desc.device)
    mid_level = max(levels - levels_up, 0)
    mid_nodes = torch.zeros_like(current)
    for level in range(levels):
        ch = children[current]                                   # [N, k]
        has = ch >= 0
        ch_safe = torch.clamp_min(ch, 0)
        x = node_desc[ch_safe] ^ desc[:, None, :]                # [N, k, 8]
        dist = torch.sum(_popcount32(x), dim=-1)
        dist = torch.where(has, dist, 1 << 20)
        nxt = torch.gather(ch_safe, 1, _first_argmin(dist)[:, None])[:, 0]
        current = torch.where(torch.any(has, dim=1), nxt, current)
        if level + 1 == mid_level:
            mid_nodes = current
    return word_id[current], mid_nodes


class DeviceTables(NamedTuple):
    """A vocabulary's tables on one device. As part of a graph's key it
    hashes and compares by the tensors' identities (never by their
    values), so the graph reads these very tensors, and the key keeps
    them alive while the graph lives."""
    children: torch.Tensor   # [n_nodes, k] int64
    node_desc: torch.Tensor  # [n_nodes, 8] int32
    word_id: torch.Tensor    # [n_nodes] int64

    def __eq__(self, other):
        return isinstance(other, DeviceTables) and all(a is b for a, b in zip(self, other))

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(tuple(id(t) for t in self))


def _descend_tables(desc: torch.Tensor, key):
    tables, levels, levels_up = key
    return _descend(desc, *tables, levels, levels_up)


def _descend_jit(desc: torch.Tensor, children: torch.Tensor, node_desc: torch.Tensor,
                 word_id: torch.Tensor, levels: int, levels_up: int):
    """_descend through utils/cuda_graph.call, the tables in the key: one
    replay on the card, eagerly on the CPU."""
    return cuda_graph.call(_descend_tables, (desc,),
                           (DeviceTables(children, node_desc, word_id), levels, levels_up))


# The functions _descend_jit captures (cuda_graph.release's owners).
GRAPHED = (_descend_tables,)


@dataclasses.dataclass
class BinaryVocabulary:
    k: int
    levels: int
    children: np.ndarray     # [n_nodes, k] int32, -1 absent
    node_desc: np.ndarray    # [n_nodes, 8] uint32
    node_level: np.ndarray   # [n_nodes] int32 (root = 0)
    word_id: np.ndarray      # [n_nodes] int32, -1 for internal nodes
    word_weight: np.ndarray  # [n_words] float32 (idf)
    n_words: int

    @classmethod
    def train(cls, descriptors: np.ndarray, k: int = 9, levels: int = 3,
              seed: int = 0) -> "BinaryVocabulary":
        """Hierarchical k-means over [N, 8] packed descriptors
        (TemplatedVocabulary::create, HKmeansStep)."""
        rng = np.random.default_rng(seed)
        children_list = [[-1] * k]
        desc_list = [np.zeros(8, np.uint32)]
        level_list = [0]
        word_list = [-1]
        word_hits: list = []

        def build(node_id: int, descs: np.ndarray, level: int):
            if level == levels or descs.shape[0] <= 1:
                word_list[node_id] = len(word_hits)
                word_hits.append(descs.shape[0])
                return
            cents, labels = _kmeans_binary(descs, k, rng)
            for c in range(cents.shape[0]):
                child_id = len(children_list)
                children_list.append([-1] * k)
                desc_list.append(cents[c])
                level_list.append(level + 1)
                word_list.append(-1)
                children_list[node_id][c] = child_id
                build(child_id, descs[labels == c], level + 1)

        build(0, descriptors.astype(np.uint32), 0)
        # IDF weights from the training corpus (DBoW2 TF_IDF, idf =
        # log(N / n_i)), every word counted as seen at least once.
        hits = np.maximum(np.asarray(word_hits, np.float64), 1.0)
        weights = np.maximum(
            np.log(max(descriptors.shape[0], 1) / hits).astype(np.float32), 1e-3)
        return cls(k=k, levels=levels, children=np.asarray(children_list, np.int32),
                   node_desc=np.stack(desc_list).astype(np.uint32),
                   node_level=np.asarray(level_list, np.int32),
                   word_id=np.asarray(word_list, np.int32), word_weight=weights,
                   n_words=len(word_hits))

    def device_tables(self, device) -> DeviceTables:
        """(children, node_desc, word_id) on `device`, uploaded once per
        device (~85 MB for the bundled vocabulary); the tree does not
        change after construction."""
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_device_cache", {})
        if dev not in cache:
            cache[dev] = DeviceTables(torch.from_numpy(self.children.astype(np.int64)).to(dev),
                                      to_device(self.node_desc, dev),
                                      torch.from_numpy(self.word_id.astype(np.int64)).to(dev))
        return cache[dev]

    def transform(self, desc, valid: np.ndarray, levels_up: int = 2,
                  device="cuda") -> Tuple[np.ndarray, np.ndarray]:
        """[N, 8] descriptors (uint32 numpy, or an int32 tensor) -> (word
        ids [N], node ids at depth levels - levels_up [N]) as numpy, -1 for
        invalid features (TemplatedVocabulary::transform(feature, word,
        node, levelsup), :1218-1259). The descent runs on `device`, one
        graph replay on the card (`_descend_jit`)."""
        dev = resolve_device(device)
        d = desc.to(dev) if isinstance(desc, torch.Tensor) else to_device(desc, dev)
        words, nodes = _descend_jit(d, *self.device_tables(dev), self.levels, levels_up)
        valid = np.asarray(valid, bool)
        return (np.where(valid, to_host(words), -1).astype(np.int32),
                np.where(valid, to_host(nodes), -1).astype(np.int32))

    def bow_vector(self, words: np.ndarray) -> np.ndarray:
        """Dense L1-normalized TF-IDF vector [n_words] (negatives ignored)."""
        v = np.zeros(self.n_words, np.float32)
        w = words[words >= 0]
        np.add.at(v, w, self.word_weight[w])
        s = v.sum()
        return v / s if s > 0 else v

    @staticmethod
    def score(v1: np.ndarray, v2: np.ndarray) -> float:
        """DBoW2's L1 score in [0, 1]: 1 - |v1 - v2|_1 / 2."""
        return float(1.0 - 0.5 * np.abs(v1 - v2).sum())

    def sparse_bow(self, words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse L1-normalized TF-IDF vector: (sorted unique word ids [U]
        int64, weights [U] float32), memory independent of the vocabulary's
        size (DBoW2's BowVector is a sparse map)."""
        w = words[words >= 0]
        if w.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        uw, inv = np.unique(w, return_inverse=True)
        wt = np.zeros(uw.size, np.float32)
        np.add.at(wt, inv, self.word_weight[w])
        s = wt.sum()
        if s > 0:
            wt /= s
        return uw.astype(np.int64), wt

    @staticmethod
    def sparse_score(uw1: np.ndarray, wt1: np.ndarray, uw2: np.ndarray,
                     wt2: np.ndarray) -> float:
        """L1 score between two sparse BoW vectors (sorted unique ids;
        padding entries uw < 0 allowed); empty vectors score 0."""
        m1, m2 = uw1 >= 0, uw2 >= 0
        uw1, wt1, uw2, wt2 = uw1[m1], wt1[m1], uw2[m2], wt2[m2]
        if uw1.size == 0 or uw2.size == 0:
            return 0.0
        idx = np.clip(np.searchsorted(uw1, uw2), 0, uw1.size - 1)
        match = uw1[idx] == uw2
        inter1 = wt1[idx][match]
        inter2 = wt2[match]
        l1 = ((wt1.sum() - inter1.sum()) + (wt2.sum() - inter2.sum())
              + np.abs(inter1 - inter2).sum())
        return float(1.0 - 0.5 * l1)

    # Text rows as the reference's ORBvoc.txt: a "k L s1 s2" header, then
    # "parent isLeaf 32-bytes weight" per node (TemplatedVocabulary.h:1338-1417).

    def save_text(self, path: str) -> None:
        n_nodes = self.children.shape[0]
        parent = np.full(n_nodes, -1, np.int64)
        rows, cols = np.nonzero(self.children >= 0)
        parent[self.children[rows, cols]] = rows
        with open(path, "w") as f:
            f.write(f"{self.k} {self.levels} 0 0\n")
            for nid in range(1, n_nodes):
                is_leaf = int(self.word_id[nid] >= 0)
                wt = self.word_weight[self.word_id[nid]] if is_leaf else 0.0
                f.write(f"{parent[nid]} {is_leaf} "
                        + " ".join(str(int(b)) for b in self.node_desc[nid].view(np.uint8))
                        + f" {wt}\n")

    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path, k=self.k, levels=self.levels, children=self.children,
            node_desc=self.node_desc, node_level=self.node_level, word_id=self.word_id,
            word_weight=self.word_weight, n_words=self.n_words)

    @classmethod
    def load_npz(cls, path: str) -> "BinaryVocabulary":
        z = np.load(path)
        return cls(k=int(z["k"]), levels=int(z["levels"]), children=z["children"],
                   node_desc=z["node_desc"], node_level=z["node_level"],
                   word_id=z["word_id"], word_weight=z["word_weight"],
                   n_words=int(z["n_words"]))

    @classmethod
    def load_text(cls, path: str) -> "BinaryVocabulary":
        with open(path) as f:
            header = f.readline().split()
            k, levels = int(header[0]), int(header[1])
            rows = [line.split() for line in f if line.strip()]
        n_nodes = len(rows) + 1
        children = np.full((n_nodes, k), -1, np.int32)
        node_desc = np.zeros((n_nodes, 8), np.uint32)
        node_level = np.zeros(n_nodes, np.int32)
        word_id = np.full(n_nodes, -1, np.int32)
        weights = []
        child_count = np.zeros(n_nodes, np.int32)
        for nid, row in enumerate(rows, start=1):
            parent = int(row[0])
            node_desc[nid] = np.asarray([int(x) for x in row[2:34]], np.uint8).view(np.uint32)
            children[parent, child_count[parent]] = nid
            child_count[parent] += 1
            node_level[nid] = node_level[parent] + 1
            if int(row[1]):
                word_id[nid] = len(weights)
                weights.append(float(row[34]))
        return cls(k=k, levels=levels, children=children, node_desc=node_desc,
                   node_level=node_level, word_id=word_id,
                   word_weight=np.asarray(weights, np.float32), n_words=len(weights))


_DEFAULT_VOC_CACHE: list = []


def default_vocabulary() -> Optional[BinaryVocabulary]:
    """The bundled vocabulary (k = 10, 6 levels, 614,815 words), loaded
    once per process; None when the file is absent."""
    if not _DEFAULT_VOC_CACHE:
        _DEFAULT_VOC_CACHE.append(BinaryVocabulary.load_npz(DEFAULT_VOC_PATH)
                                  if os.path.exists(DEFAULT_VOC_PATH) else None)
    return _DEFAULT_VOC_CACHE[0]


def load_vocabulary(path: str) -> BinaryVocabulary:
    """.npz (the bundled format) or the reference's ORBvoc.txt row layout."""
    if path.endswith(".npz"):
        return BinaryVocabulary.load_npz(path)
    return BinaryVocabulary.load_text(path)
