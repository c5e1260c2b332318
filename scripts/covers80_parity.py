"""One-command covers80 real-audio parity recipe.

Runs the complete reference experiment on the covers80 dataset: feature
extraction -> all algorithm families in reference-literal parity
configuration -> one `results_covers80.csv` in the reference's CSV schema
(`/root/reference/benchmarking/CoverAlgorithm.py:404-417`,
`runcovers80.sh`). The moment the real covers80 mp3s exist the run is:

    # fetch (needs network; ~250 MB):
    curl -LO https://labrosa.ee.columbia.edu/projects/coversongs/\
covers80/covers80.tgz && tar xzf covers80.tgz
    # run everything:
    python scripts/covers80_parity.py --audio-dir covers32k

Without the dataset, `--make-placeholder` synthesizes a stand-in corpus
with the exact covers32k directory/list layout (80 cliques x 2 covers of
noisy chord-progression WAVs, transposed + tempo-warped) so the recipe is
exercised end-to-end; it executes unmodified on the real mp3s.

Parity notes (reference-literal defaults are already pinned in code):
- ChenFusion: stack_n_steps=1 (the reference's no-op stack_memory call)
  and sequential late SNF;
- SNF consumers default to the reference's in-place (sequential) update
  order; kNN selections are exact top-k;
- Serra09 runs the FULL 6-type configuration (do_ssms=True);
- binarization is mutual exactly where the reference's is
  (Serra09/EarlySNF) and plain row-kNN where it is not (ChenFusion,
  Tempogram, StrucLaplacian).
- feature substitutions vs the reference (documented in
  `acoss_jax/features/pipeline.py`): madmom RNN+DBN -> superflux + DP
  tracker; CREMA -> chord-template HMM chroma; essentia HPCP -> JAX HPCP.
  MAP comparisons against published covers80 numbers should expect
  feature-level (not convention-level) deviations.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SR = 44100


def make_placeholder(covers32k: str, seed: int = 0,
                     n_cliques: int = 80) -> None:
    """Synthesize a covers80-layout placeholder corpus (WAV).

    v2 (round 5): the v1 corpus only planted a shared chord sequence in
    ~18 s songs, so every channel except raw chroma alignment scored at
    chance (FTM2D's shingle needs > 75 BEATS — `FTM2D.py:88` returns a
    zero shingle below that — and the Struc*/mfcc channels respond to
    section structure and timbre the v1 audio didn't share). Each song
    now plants what the corresponding reference channels actually read:

    - ~60-75 s with a percussive beat grid (~2.3 beats/s, > 110 beats;
      clique-shared tempo curve, per-cover global tempo factor) so the
      onset tracker yields the beat sequence FTM2D/Struc* synchronize
      to (`FTM2D.py:90`, `StrucFTM2D.py:63-75`);
    - a verse/chorus FORM (A B A B C B of 8-chord sections, shared
      within the clique, transposed per cover) so block SSMs / fused Ws
      carry repeated-section structure (`StrucFTM2D.py:50-158`);
    - a clique-specific instrument TIMBRE (harmonic overtone profile)
      so MFCC-based channels (Serra09 mfcc, EarlyFusion ssms,
      StrucFTM2D's MFCC SSM) see cover-invariant spectral envelopes.
    """
    import numpy as np

    from acoss_jax.features.audio import save_wav

    rng = np.random.default_rng(seed)
    names = [f"artist{c:02d}_song{c:02d}" for c in range(n_cliques)]
    lists = {"list1.list": [], "list2.list": []}

    def chord_audio(states, beats_per_chord, transpose, tempo_factor,
                    tempo_curve, timbre, prng):
        beat0 = 0.43 * tempo_factor          # ~2.3 beats/s at factor 1
        sig_parts = []
        k = 0
        for s, nb in zip(states, beats_per_chord):
            root = (s // 2 + transpose) % 12
            third = 4 if s % 2 == 0 else 3
            dur = 0.0
            beat_ts = []
            for _ in range(int(nb)):
                beat_ts.append(dur)
                dur += beat0 * tempo_curve[k % len(tempo_curve)]
                k += 1
            n = int(dur * SR)
            t = np.arange(n) / SR
            sig = np.zeros(n)
            for iv in (0, third, 7):
                f0 = 440.0 * 2 ** (((root + iv) - 9) / 12 - 1)
                for h, amp in enumerate(timbre, start=1):
                    fh = f0 * h
                    if fh > 8000:
                        break
                    sig += amp * np.sin(2 * np.pi * fh * t +
                                        prng.uniform(0, 6.28))
            sig /= max(np.abs(sig).max(), 1e-9)
            # percussive beat: short noise bursts at the beat grid (the
            # superflux novelty + DP tracker lock onto these)
            for bt in beat_ts:
                i0 = int(bt * SR)
                ln = min(int(0.03 * SR), n - i0)
                if ln > 0:
                    env = np.exp(-np.arange(ln) / (0.006 * SR))
                    sig[i0:i0 + ln] += 1.4 * env * prng.normal(size=ln)
            sig_parts.append(sig)
        y = np.concatenate(sig_parts)
        y += 0.05 * prng.normal(size=y.size)
        return (0.8 * y / np.abs(y).max()).astype(np.float32)

    for c, name in enumerate(names):
        os.makedirs(os.path.join(covers32k, name), exist_ok=True)
        # verse/chorus form: 3 distinct 8-chord sections, A B A B C B
        sections = [rng.integers(0, 24, size=8) for _ in range(3)]
        form = [0, 1, 0, 1, 2, 1]
        states = np.concatenate([sections[f] for f in form])
        beats_per_chord = rng.integers(2, 5, size=states.size)
        # clique-shared latents: tempo curve + instrument timbre
        raw = rng.normal(0, 1, 32)
        kern = np.exp(-0.5 * (np.arange(-6, 7) / 3.0) ** 2)
        sm = np.convolve(raw, kern / kern.sum(), mode="same")
        tempo_curve = 1.0 + 0.12 * sm / max(np.abs(sm).max(), 1e-9)
        timbre = rng.random(10) ** 2 * (1.0 / np.arange(1, 11))
        timbre /= timbre.sum()
        for p, listfile in enumerate(lists):
            tp = int(rng.integers(0, 12)) if p else 0
            fac = float(rng.uniform(0.85, 1.2)) if p else 1.0
            rel = f"{name}/take{p}"
            save_wav(os.path.join(covers32k, rel + ".wav"),
                     chord_audio(states, beats_per_chord, tp, fac,
                                 tempo_curve, timbre, rng), SR)
            lists[listfile].append(rel)
    for listfile, rels in lists.items():
        with open(os.path.join(covers32k, listfile), "w") as f:
            f.write("\n".join(rels) + "\n")
    print(f"placeholder corpus written to {covers32k} "
          f"({2 * n_cliques} tracks)")


def parity_algorithms():
    """The 12 reference algorithm families, parity-configured."""
    from acoss_jax.benchmarking.algorithms import ALL_ALGORITHMS as A
    return [
        ("Serra09", lambda: A["Serra09"](do_ssms=True)),
        ("FTM2D", lambda: A["FTM2D"]()),
        ("FTM2D_noLog", lambda: A["FTM2D"](do_log=False)),
        ("FTM2D_noNorm", lambda: A["FTM2D"](do_norm=False)),
        ("FTM2D_noNormNoLog",
         lambda: A["FTM2D"](do_log=False, do_norm=False)),
        ("FTM2D_zeroPad", lambda: A["FTM2D"](mode="zeropad",
                                             do_log=False)),
        ("FTM2D_zeroPadLog", lambda: A["FTM2D"](mode="zeropad",
                                                do_log=True)),
        ("ChenFusion", lambda: A["ChenFusion"]()),
        ("EarlySNF", lambda: A["EarlySNF"]()),
        ("EarlyFusion", lambda: A["EarlyFusion"]()),
        ("Simple", lambda: A["Simple"]()),
        ("TGAlg", lambda: A["TGAlg"]()),
        ("ANFScattering", lambda: A["ANFScattering"]()),
        ("StrucFTM2D", lambda: A["StrucFTM2D"]()),
        ("StrucShingles", lambda: A["StrucShingles"]()),
        ("StrucLaplacian", lambda: A["StructureLaplacian"]()),
        ("StrucScattering", lambda: A["StrucScattering"]()),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--audio-dir", default="covers32k",
                    help="covers32k directory (list1.list/list2.list)")
    ap.add_argument("--make-placeholder", action="store_true",
                    help="synthesize a covers80-layout WAV corpus if the "
                         "real dataset is absent")
    ap.add_argument("--placeholder-cliques", type=int, default=80)
    ap.add_argument("--features", default="covers80_features.npz")
    ap.add_argument("--csv", default="results_covers80.csv")
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset of algorithm names to run")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")

    from acoss_jax.benchmarking.evaluation import write_results_csv
    from acoss_jax.benchmarking.harness import benchmark
    from acoss_jax.data.manifest import covers80_list
    from acoss_jax.data.store import FeatureSet

    listfile = os.path.join(args.audio_dir, "list1.list")
    if not os.path.exists(listfile):
        if args.make_placeholder:
            make_placeholder(args.audio_dir,
                             n_cliques=args.placeholder_cliques)
        else:
            print(
                f"covers80 dataset not found at {args.audio_dir}.\n"
                "Fetch it with:\n"
                "  curl -LO https://labrosa.ee.columbia.edu/projects/"
                "coversongs/covers80/covers80.tgz && tar xzf covers80.tgz\n"
                "or pass --make-placeholder for a synthetic stand-in.",
                file=sys.stderr)
            return 1

    # ---- extraction (reused if the feature file already exists) --------
    if os.path.exists(args.features):
        print(f"reusing features {args.features}")
        fs = FeatureSet.load(args.features)
    else:
        from acoss_jax.features.pipeline import batch_extract
        paths, labels = covers80_list(args.audio_dir)
        # the real dataset ships .mp3; the placeholder ships .wav
        paths = [p if os.path.exists(p)
                 else os.path.splitext(p)[0] + ".wav" for p in paths]
        t0 = time.time()
        fs = batch_extract(paths, labels,
                           error_log="covers80_extract_errors.txt")
        fs.save(args.features)
        print(f"extracted {fs.n_songs} songs in {time.time() - t0:.0f}s "
              f"-> {args.features}")

    # ---- benchmarks ----------------------------------------------------
    for name, make in parity_algorithms():
        if args.only and name not in args.only:
            continue
        alg = make()
        t0 = time.time()
        try:
            stats = benchmark(alg, fs)
        except Exception as e:  # keep the sweep going, reference-style
            print(json.dumps({"algorithm": name, "error": repr(e)}),
                  flush=True)
            continue
        wall = time.time() - t0
        for k, s in stats.items():
            write_results_csv(args.csv, name, k, s)
        print(json.dumps({
            "algorithm": name, "wall_s": round(wall, 1),
            "map": {k: round(float(v.map), 4) for k, v in stats.items()},
        }), flush=True)
    print(f"results appended to {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
