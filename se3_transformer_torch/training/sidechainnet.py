"""Sidechainnet-format converter: real protein data -> PointCloudDataset;
the port of se3_transformer_tpu/training/sidechainnet.py (numpy only, the
same arrays).

A sidechainnet export keeps each residue's 14-atom frame; the denoise
trainer keeps only its 3 backbone atoms (N, CA, C), tokens and masks
repeated x3. The sidechainnet package is not needed: its on-disk pickle
layout is a plain dict of splits:

    {'train': {'seq': [str],          # one-letter AA strings, len L
               'crd': [ndarray],      # [14*L, 3] all-atom coordinates
               'msk': [str], ...},    # '+'/'-' per residue (resolved?)
     'valid-10': {...}, 'test': {...}}

`convert_sidechainnet` consumes exactly that layout (from a pickle or an
already-loaded dict) and writes the framework's .npz ragged dataset
(training.dataset) with:

  * backbone atoms only (N, CA, C -> 3 nodes per residue), token id
    repeated per atom;
  * per-node masks from the '-' residues (unresolved -> masked out);
  * unresolved residues' zero-filled coordinates left in place but
    masked, matching sidechainnet semantics.

Token vocabulary: the 20 standard AAs in sidechainnet's alphabetical
one-letter order plus 'X' (unknown); ids are stable and documented here
rather than imported, so converted datasets are self-consistent without
the sidechainnet package. num_tokens=24 in the flagship config leaves
room for pad/unk extensions.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from .dataset import save_point_cloud_dataset

# sidechainnet one-letter vocabulary (standard 20 AAs, alphabetical by
# letter) + 'X' for unknown/nonstandard
AA_LETTERS = 'ACDEFGHIKLMNPQRSTVWY'
AA_TO_ID: Dict[str, int] = {a: i for i, a in enumerate(AA_LETTERS)}
UNK_ID = len(AA_LETTERS)  # 'X' and anything else

ATOMS_PER_RESIDUE = 14      # sidechainnet all-atom frame
BACKBONE_ATOMS = 3          # N, CA, C


def tokenize_sequence(seq: str) -> np.ndarray:
    return np.asarray([AA_TO_ID.get(a, UNK_ID) for a in seq], np.int32)


def convert_sidechainnet(data, out_path: str,
                         splits: Sequence[str] = ('train',),
                         max_len: Optional[int] = 500,
                         min_resolved: float = 0.5) -> str:
    """Convert a sidechainnet-format dict (or pickle path) to the .npz
    ragged dataset layout. Returns the written path.

    max_len drops proteins longer than the threshold in residues (500 by
    default, as the sidechainnet trainer skips them); min_resolved drops
    entries
    where fewer than that fraction of residues are resolved (nearly-empty
    masks train on noise).
    """
    if isinstance(data, (str, bytes, os.PathLike)):
        # a sidechainnet export is a pickle: load only files you trust
        with open(data, 'rb') as f:
            data = pickle.load(f)

    token_seqs, coord_seqs, mask_seqs = [], [], []
    for split in splits:
        entry = data[split]
        seqs, crds = entry['seq'], entry['crd']
        msks = entry.get('msk', [None] * len(seqs))
        for seq, crd, msk in zip(seqs, crds, msks):
            L = len(seq)
            if max_len is not None and L > max_len:
                continue
            crd = np.asarray(crd, np.float32).reshape(-1, 3)
            if crd.shape[0] != L * ATOMS_PER_RESIDUE:
                raise ValueError(
                    f'coordinate rows {crd.shape[0]} != {ATOMS_PER_RESIDUE}'
                    f' * {L} residues — not a sidechainnet all-atom frame')
            resolved = np.asarray(
                [c == '+' for c in msk] if msk is not None else [True] * L,
                bool)
            if resolved.mean() < min_resolved:
                continue
            backbone = crd.reshape(L, ATOMS_PER_RESIDUE, 3)[:, :BACKBONE_ATOMS]
            tokens = np.repeat(tokenize_sequence(seq), BACKBONE_ATOMS)
            mask = np.repeat(resolved, BACKBONE_ATOMS)
            coords = backbone.reshape(L * BACKBONE_ATOMS, 3)
            # center resolved atoms (masked zeros would skew the mean)
            if resolved.any():
                coords = coords - coords[mask].mean(axis=0, keepdims=True)
            token_seqs.append(tokens)
            coord_seqs.append(coords.astype(np.float32))
            mask_seqs.append(mask)

    if not token_seqs:
        raise ValueError('no sequences survived the filters')
    return save_point_cloud_dataset(out_path, token_seqs, coord_seqs,
                                    mask_seqs)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description='Convert a sidechainnet pickle to the .npz dataset '
                    'layout that `python -m se3_transformer_torch.training.'
                    'cli --dataset` reads')
    ap.add_argument('pickle', help='sidechainnet export (.pkl)')
    ap.add_argument('out', help='output .npz path')
    ap.add_argument('--splits', nargs='+', default=['train'])
    ap.add_argument('--max-len', type=int, default=500)
    args = ap.parse_args(argv)
    path = convert_sidechainnet(args.pickle, args.out, splits=args.splits,
                                max_len=args.max_len)
    print(f'wrote {path}')


if __name__ == '__main__':
    main()
