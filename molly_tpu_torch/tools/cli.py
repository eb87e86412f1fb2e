"""Data-tools CLI: one command with subcommands replacing the reference's
17 standalone scripts (SURVEY.md §2.2).

  python -m molly_tpu_torch.tools.cli convert --src out.jsonl --dst eval.jsonl
  python -m molly_tpu_torch.tools.cli to-parquet --src data.jsonl --dst d.parquet
  python -m molly_tpu_torch.tools.cli split --src d.parquet --ratio 0.8
  python -m molly_tpu_torch.tools.cli merge --out all.parquet a.parquet b.parquet
  python -m molly_tpu_torch.tools.cli leak-check --file1 tr.parquet --file2 te.parquet
  python -m molly_tpu_torch.tools.cli stats --src d.parquet
  python -m molly_tpu_torch.tools.cli subsample --src d.parquet --n 100 --dst s.parquet
  python -m molly_tpu_torch.tools.cli inspect --src d.jsonl --preview 3
"""

from __future__ import annotations

import argparse
import json
import sys

from . import data_tools as dt


def main(argv=None) -> None:
    p = argparse.ArgumentParser("molly_tpu_torch data tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="inference JSONL -> eval format")
    c.add_argument("--src", required=True)
    c.add_argument("--dst", required=True)

    c = sub.add_parser("to-parquet", help="jsonl -> 6-col parquet")
    c.add_argument("--src", required=True)
    c.add_argument("--dst", required=True)
    c.add_argument("--no-validate", action="store_true")

    c = sub.add_parser("split", help="per-task train/val split")
    c.add_argument("--src", required=True)
    c.add_argument("--ratio", type=float, default=0.8)
    c.add_argument("--seed", type=int, default=42)

    c = sub.add_parser("merge")
    c.add_argument("--out", required=True)
    c.add_argument("--shuffle", action="store_true")
    c.add_argument("inputs", nargs="+")

    c = sub.add_parser("leak-check")
    c.add_argument("--file1", required=True)
    c.add_argument("--file2", required=True)
    c.add_argument("--column", default="input")

    c = sub.add_parser("stats")
    c.add_argument("--src", required=True)

    c = sub.add_parser("subsample")
    c.add_argument("--src", required=True)
    c.add_argument("--dst", required=True)
    c.add_argument("--n", type=int, required=True)

    c = sub.add_parser("inspect", help="jsonl/parquet preview + task counts")
    c.add_argument("--src", required=True)
    c.add_argument("--preview", type=int, default=2)

    c = sub.add_parser("ablation",
                       help="task-subset split by tagged modalities "
                            "(reference scripts/train/run_train_dna.sh "
                            "etc. train on such subsets)")
    c.add_argument("--src", required=True)
    c.add_argument("--dst", required=True)
    c.add_argument("--modalities", required=True,
                   help="comma list from {dna,rna,protein}")

    c = sub.add_parser("kegg", help="KEGG free-text accuracy report "
                                    "(reference compute_kegg.py)")
    c.add_argument("--src", required=True, help="inference JSONL")
    c.add_argument("--confusion-png", default=None)

    c = sub.add_parser("count-tokens",
                       help="LLM-token stats per column (reference "
                            "count_token_llm.py)")
    c.add_argument("--src", required=True)
    c.add_argument("--column", default="output")
    c.add_argument("--model-path", default=None,
                   help="HF tokenizer dir; default = bundled byte "
                        "fallback tokenizer")

    args = p.parse_args(argv)
    import pandas as pd

    if args.cmd == "convert":
        n = dt.convert_inference_jsonl(args.src, args.dst)
        print(f"converted {n} records -> {args.dst}")
    elif args.cmd == "to-parquet":
        n, dropped = dt.jsonl_to_parquet(args.src, args.dst,
                                         validate=not args.no_validate)
        print(f"wrote {n} rows ({dropped} dropped by validation)")
    elif args.cmd == "split":
        df = pd.read_parquet(args.src)
        tr, va = dt.split_by_task(df, args.ratio, args.seed)
        base = args.src.rsplit(".parquet", 1)[0]
        tr.to_parquet(base + "_train.parquet")
        va.to_parquet(base + "_val.parquet")
        print(f"split {len(df)} -> {len(tr)} train / {len(va)} val")
    elif args.cmd == "merge":
        n = dt.merge_parquets(args.inputs, args.out, shuffle=args.shuffle)
        print(f"merged {n} rows -> {args.out}")
    elif args.cmd == "leak-check":
        res = dt.check_data_leak(args.file1, args.file2, args.column)
        print(json.dumps(res, indent=2))
        if res["overlap"]:
            sys.exit(1)
    elif args.cmd == "stats":
        df = pd.read_parquet(args.src)
        print(json.dumps(dt.dataset_stats(df), indent=2))
    elif args.cmd == "subsample":
        df = pd.read_parquet(args.src)
        out = dt.balanced_subsample(df, args.n)
        out.to_parquet(args.dst)
        print(f"subsampled {len(df)} -> {len(out)}")
    elif args.cmd == "ablation":
        df = pd.read_parquet(args.src)
        out = dt.ablation_subset(df, args.modalities.split(","))
        out.to_parquet(args.dst)
        print(f"ablation[{args.modalities}]: {len(df)} -> {len(out)} rows "
              f"-> {args.dst}")
    elif args.cmd == "kegg":
        print(json.dumps(dt.kegg_report(args.src, args.confusion_png),
                         indent=2))
    elif args.cmd == "count-tokens":
        if args.model_path:
            from transformers import AutoTokenizer
            tok = AutoTokenizer.from_pretrained(args.model_path)
        else:
            from ..data.tokenizers import ByteTextTokenizer
            tok = ByteTextTokenizer()
        df = pd.read_parquet(args.src)
        print(json.dumps(dt.count_tokens_with_tokenizer(
            df, tok, args.column), indent=2))
    elif args.cmd == "inspect":
        if args.src.endswith((".jsonl", ".json")):
            rows = [json.loads(l) for l in open(args.src) if l.strip()]
            df = pd.DataFrame(rows)
        else:
            df = pd.read_parquet(args.src)
        print(f"{len(df)} rows; columns: {list(df.columns)}")
        if "task" in df:
            print("per-task counts:")
            for t, n in df["task"].value_counts().items():
                print(f"  {t}: {n}")
        for i in range(min(args.preview, len(df))):
            print(f"--- row {i} ---")
            print(json.dumps({k: str(v)[:160] for k, v in
                              df.iloc[i].to_dict().items()}, indent=1))


if __name__ == "__main__":
    main()
