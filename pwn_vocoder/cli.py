"""Command-line entry points (layer T7; reference: `python train.py <case>`
/ `python generate.py <case>` [R], SURVEY.md §1 L7).

    python -m pwn_vocoder.cli train-teacher  <case> [--workdir D]
                              [--data-dir D] [--steps N] [k=v ...]
    python -m pwn_vocoder.cli train-student  <case> [--workdir D] [...]
                              (direct, no teacher)
    python -m pwn_vocoder.cli distill-student <case> --teacher-workdir D
    python -m pwn_vocoder.cli generate        <case> --workdir D
                              [--source F] [--model student|teacher]
    python -m pwn_vocoder.cli bench           [case]

`<case>` is a named preset (the reference's YAML "case"); `key=value`
pairs anywhere after it override dotted config fields, e.g.
`train.learning_rate=3e-4`.
"""

from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np


def _parse_overrides(pairs):
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"override must be key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def _load_config(case: str, overrides):
    from pwn_vocoder.config import get_config

    return get_config(case, **_parse_overrides(overrides))


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pwn_vocoder")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train-teacher", help="train the AR teacher")
    p_train.add_argument("case")
    p_train.add_argument("--workdir", default="runs/teacher")
    p_train.add_argument("--data-dir", default=None,
                         help="wav corpus dir (default: synthetic tones)")
    p_train.add_argument("--steps", type=int, default=None)
    p_train.add_argument("overrides", nargs="*")

    p_sdir = sub.add_parser(
        "train-student",
        help="train the student IAF directly (no teacher): closed-form "
             "likelihood + power loss",
    )
    p_sdir.add_argument("case")
    p_sdir.add_argument("--workdir", default="runs/student")
    p_sdir.add_argument("--data-dir", default=None)
    p_sdir.add_argument("--steps", type=int, default=None)
    p_sdir.add_argument("overrides", nargs="*")

    p_dist = sub.add_parser("distill-student",
                            help="distill the student IAF from a teacher")
    p_dist.add_argument("case")
    p_dist.add_argument("--teacher-workdir", required=True)
    p_dist.add_argument("--teacher-case", default=None,
                        help="case the teacher was trained with "
                             "(default: same case)")
    p_dist.add_argument("--workdir", default="runs/student")
    p_dist.add_argument("--data-dir", default=None)
    p_dist.add_argument("--steps", type=int, default=None)
    p_dist.add_argument("--teacher-step", default="latest",
                        help="teacher checkpoint step to distill from: "
                             "an integer, 'latest', or 'auto' "
                             "(distillability probe: short-distill "
                             "against every retained teacher ckpt and "
                             "pick the lowest held-out KL — guards the "
                             "measured 3x regression from overtrained "
                             "teachers, BASELINE.md r4)")
    p_dist.add_argument("--teacher-probe-steps", type=int, default=500,
                        help="distill steps per candidate for "
                             "--teacher-step auto")
    p_dist.add_argument("--teacher-params", choices=["ema", "live"],
                        default="ema",
                        help="use the EMA (Polyak-averaged) teacher "
                             "params when the checkpoint carries them "
                             "(the Parallel WaveNet recipe) or the "
                             "live unaveraged params")
    p_dist.add_argument("overrides", nargs="*")

    p_gen = sub.add_parser("generate", help="synthesize a waveform")
    p_gen.add_argument("case")
    p_gen.add_argument("--workdir", required=True)
    p_gen.add_argument("--model", choices=["student", "teacher"],
                       default="student")
    p_gen.add_argument("--source", default=None,
                       help="source wav for copy-synthesis mel "
                            "(default: synthetic clip)")
    p_gen.add_argument("--output", default="generated.wav")
    p_gen.add_argument("--mel", default=None,
                       help="condition on a (frames, n_mels) float .npy "
                            "mel instead of a source wav — the "
                            "production vocoder input (convention: "
                            "generate.coerce_mel; produce one with "
                            "--dump-mel)")
    p_gen.add_argument("--dump-mel", default=None,
                       help="also write the conditioning mel to this "
                            ".npy path (calibration artifact for "
                            "--mel / npy serving)")
    p_gen.add_argument("--source-dir", default=None,
                       help="batch mode: vocode every .wav under this "
                            "dir (student only) at batched device "
                            "throughput; see --output-dir")
    p_gen.add_argument("--mel-dir", default=None,
                       help="batch mode over (frames, n_mels) .npy "
                            "mels instead of wavs")
    p_gen.add_argument("--output-dir", default=None,
                       help="where batch mode writes <stem>.wav "
                            "(default: alongside --output)")
    p_gen.add_argument("--batch-size", type=int, default=8,
                       help="batch-mode device batch")
    p_gen.add_argument("--bucket-frames", type=int, default=64,
                       help="batch-mode length buckets, in mel frames "
                            "(one flow-stack compile per bucket)")
    p_gen.add_argument("--seconds", type=float, default=1.0)
    p_gen.add_argument("--temperature", type=float, default=1.0)
    p_gen.add_argument("--chunk-frames", type=int, default=0,
                       help="student streaming mode: synthesize in "
                            "chunks of this many mel frames with "
                            "receptive-field overlap recompute (bounded "
                            "memory; 0 = single whole-utterance call)")
    p_gen.add_argument("overrides", nargs="*")

    p_eval = sub.add_parser(
        "eval", help="copy-synthesis quality metrics between two wavs")
    p_eval.add_argument("case")
    p_eval.add_argument("--ref", required=True)
    p_eval.add_argument("--gen", required=True)
    p_eval.add_argument("overrides", nargs="*")

    p_srv = sub.add_parser(
        "serve",
        help="streaming vocoder HTTP server (POST /synthesize with a "
             "wav body -> chunked PCM16; GET /healthz)",
    )
    p_srv.add_argument("case")
    p_srv.add_argument("--workdir", default="runs/student")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8600)
    p_srv.add_argument("--chunk-frames", type=int, default=64,
                       help="mel frames per streamed chunk")
    p_srv.add_argument("--max-pending", type=int, default=4,
                       help="concurrent syntheses before 503 shedding")
    p_srv.add_argument("--max-body-mb", type=int, default=64,
                       help="request-body cap in MB (413 past it)")
    p_srv.add_argument("--batch-max", type=int, default=4,
                       help="cross-request dynamic batching: max "
                            "concurrent streams per device call "
                            "(1 disables)")
    p_srv.add_argument("--batch-window-ms", type=float, default=3.0,
                       help="job gather window once >1 synthesis "
                            "is pending")
    p_srv.add_argument("overrides", nargs="*")

    p_bench = sub.add_parser("bench", help="run the benchmark suite")
    p_bench.add_argument("case", nargs="?", default="student_iaf")
    p_bench.add_argument("overrides", nargs="*")

    return parser


def parse_args(argv=None) -> argparse.Namespace:
    """Parse a command line; `key=value` overrides may come before or
    after the options (argparse alone rejects a `nargs="*"` positional
    after options on some Python versions)."""
    parser = _parser()
    args, extra = parser.parse_known_args(argv)
    args.overrides = list(args.overrides) + extra
    bad = [a for a in args.overrides if a.startswith("-") or "=" not in a]
    if bad:
        parser.error(f"unrecognized arguments: {' '.join(bad)}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    from pwn_vocoder.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.cmd == "train-teacher":
        from pwn_vocoder.training.loop import run_teacher_training

        cfg = _load_config(args.case, args.overrides)
        res = run_teacher_training(
            cfg, workdir=args.workdir, data_dir=args.data_dir,
            num_steps=args.steps,
        )
        print(f"teacher done: {res.steps_run} steps, "
              f"final {res.final_metrics}")
        return 0

    if args.cmd == "train-student":
        from pwn_vocoder.training.loop import run_student_direct_training

        cfg = _load_config(args.case, args.overrides)
        res = run_student_direct_training(
            cfg, workdir=args.workdir, data_dir=args.data_dir,
            num_steps=args.steps,
        )
        print(f"student (direct) done: {res.steps_run} steps, "
              f"final {res.final_metrics}")
        return 0

    if args.cmd == "distill-student":
        from pwn_vocoder.training.loop import (
            load_teacher_params,
            run_distillation,
        )

        cfg = _load_config(args.case, args.overrides)
        tcfg = (_load_config(args.teacher_case, args.overrides)
                if args.teacher_case else cfg)
        prefer_ema = args.teacher_params == "ema"
        if args.teacher_step == "auto":
            from pwn_vocoder.training.teacher_select import select_teacher_step

            t_step = select_teacher_step(
                cfg, args.teacher_workdir, teacher_cfg=tcfg,
                data_dir=args.data_dir,
                probe_steps=args.teacher_probe_steps,
                prefer_ema=prefer_ema,
            )
        elif args.teacher_step == "latest":
            t_step = None
        else:
            t_step = int(args.teacher_step)
        _, teacher_params, tstep = load_teacher_params(
            tcfg, args.teacher_workdir, step=t_step,
            prefer_ema=prefer_ema,
        )
        print(f"loaded teacher @ step {tstep} "
              f"({args.teacher_params} params)")
        res = run_distillation(
            cfg, teacher_params, workdir=args.workdir,
            data_dir=args.data_dir, num_steps=args.steps,
        )
        print(f"student done: {res.steps_run} steps, "
              f"final {res.final_metrics}")
        return 0

    if args.cmd == "generate":
        from pwn_vocoder.data import SyntheticTones
        from pwn_vocoder.generate import (
            coerce_mel,
            generate_student,
            generate_teacher,
            mel_from_wav,
        )
        from pwn_vocoder.training.loop import load_teacher_params
        from pwn_vocoder.utils.audio_io import read_wav, write_wav

        cfg = _load_config(args.case, args.overrides)
        sr = cfg.dsp.sample_rate

        def restore_student_params():
            import os

            from pwn_vocoder.training.common import serving_params
            from pwn_vocoder.training.loop import abstract_state_template
            from pwn_vocoder.utils.checkpoint import CheckpointManager

            # shape-only template: no parameters drawn just to be
            # overwritten by the restore
            state = abstract_state_template(cfg, "student")
            state, _ = CheckpointManager(os.path.join(
                os.path.abspath(args.workdir), "ckpt_student")
            ).restore(state)
            # commit the restored host tree to device once — otherwise
            # every jit call re-uploads it
            return jax.device_put(serving_params(state))

        if args.source_dir or args.mel_dir:
            import glob
            import os
            import time

            from pwn_vocoder.generate import vocode_many

            if args.model == "teacher":
                print("batch mode is student-only", file=sys.stderr)
                return 2
            if args.mel_dir:
                paths = sorted(glob.glob(
                    os.path.join(args.mel_dir, "*.npy")))
                mels = [np.load(p, allow_pickle=False) for p in paths]
            else:
                paths = sorted(glob.glob(
                    os.path.join(args.source_dir, "*.wav")))
                # wav->mel in host numpy: an eager device mel would
                # compile once per distinct clip length
                from pwn_vocoder.generate import mel_from_wav_host

                mels = [mel_from_wav_host(
                    cfg, read_wav(p, target_sr=sr)[0]) for p in paths]
            if not paths:
                print("batch mode: no inputs found", file=sys.stderr)
                return 2
            out_dir = args.output_dir or os.path.dirname(
                os.path.abspath(args.output))
            os.makedirs(out_dir, exist_ok=True)
            gen_params = restore_student_params()
            t0 = time.perf_counter()
            wavs = vocode_many(
                cfg, gen_params, mels, jax.random.PRNGKey(0),
                temperature=args.temperature,
                batch_size=args.batch_size,
                bucket_frames=args.bucket_frames,
            )
            wall = time.perf_counter() - t0
            total = 0.0
            for p, w in zip(paths, wavs):
                stem = os.path.splitext(os.path.basename(p))[0]
                write_wav(os.path.join(out_dir, stem + ".wav"), w, sr)
                total += len(w) / sr
            print(f"vocoded {len(paths)} utterances, {total:.1f}s audio "
                  f"in {wall:.1f}s wall ({total / wall:.0f}x realtime "
                  f"incl. compile) -> {out_dir}")
            return 0

        if args.mel:
            mel = coerce_mel(cfg, np.load(args.mel, allow_pickle=False))
        else:
            if args.source:
                wav, _ = read_wav(args.source, target_sr=sr)
            else:
                wav = SyntheticTones(
                    1, int(args.seconds * sr), sr, seed=42)[0]
            mel = mel_from_wav(cfg, wav.astype(np.float32))
        if args.dump_mel:
            np.save(args.dump_mel, np.asarray(mel[0], dtype=np.float32))
            print(f"wrote mel {tuple(mel.shape[1:])} -> {args.dump_mel}")
        key = jax.random.PRNGKey(0)
        if args.model == "teacher":
            _, params, _ = load_teacher_params(cfg, args.workdir)
            out = generate_teacher(cfg, params, mel, key,
                                   args.temperature)
        else:
            gen_params = restore_student_params()
            if args.chunk_frames:
                # streaming synthesis: chunks arrive incrementally (a
                # server would ship them as they come, carrying the
                # 1-pole deemphasis state; here we assemble one wav)
                from pwn_vocoder.generate import stream_student_chunks
                from pwn_vocoder.utils import dsp as _dsp

                # cover_tail: the ragged final F % chunk_frames frames
                # stream as one partial chunk instead of being dropped
                chunks = list(stream_student_chunks(
                    cfg, gen_params, np.asarray(mel), key=key,
                    chunk_frames=args.chunk_frames,
                    temperature=args.temperature,
                    cover_tail=True,
                ))
                wav_cat = jnp.asarray(
                    np.concatenate(chunks, axis=1)
                )
                out = np.asarray(
                    _dsp.deemphasis(wav_cat, cfg.dsp.preemphasis)[0]
                )
            else:
                out = generate_student(cfg, gen_params, mel, key,
                                       args.temperature)
        write_wav(args.output, out, sr)
        print(f"wrote {args.output}: {len(out)/sr:.2f}s @ {sr} Hz")
        return 0

    if args.cmd == "eval":
        import json

        from pwn_vocoder.evaluate import copy_synthesis_report
        from pwn_vocoder.utils.audio_io import read_wav

        cfg = _load_config(args.case, args.overrides)
        ref, _ = read_wav(args.ref, target_sr=cfg.dsp.sample_rate)
        gen, _ = read_wav(args.gen, target_sr=cfg.dsp.sample_rate)
        n = min(len(ref), len(gen))
        print(json.dumps(copy_synthesis_report(cfg, ref[:n], gen[:n])))
        return 0

    if args.cmd == "serve":
        from pwn_vocoder.serve import serve_forever

        cfg = _load_config(args.case, args.overrides)
        serve_forever(cfg, args.workdir, args.host, args.port,
                      chunk_frames=args.chunk_frames,
                      max_pending=args.max_pending,
                      max_body_bytes=args.max_body_mb * 2 ** 20,
                      batch_max=args.batch_max,
                      batch_window_ms=args.batch_window_ms)
        return 0

    if args.cmd == "bench":
        from pwn_vocoder.benchmarks import run_bench

        result = run_bench(args.case, _parse_overrides(args.overrides))
        import json

        print(json.dumps(result))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
