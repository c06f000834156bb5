"""CLI entry points preserving the reference's script surface:

  python -m svdd.cli.decode            (SVDD-MC,    decode.py)
  python -m svdd.cli.decode_tweedie    (SVDD-PM,    decode_tweedie.py)
  python -m svdd.cli.decode_TDS        (TDS,        decode_TDS.py)
  python -m svdd.cli.decode_DPS        (DPS,        decode_DPS.py)
  python -m svdd.cli.decode_DG         (DPS clone,  decode_DG.py)
  python -m svdd.cli.decode_classfier  (class.guid, decode_classfier.py)
  python -m svdd.cli.main_gosai        (pretrain,   main_gosai.py)
  python -m svdd.cli.train             (value fit,  train.py)
  python -m svdd.cli.eval              (value eval, eval.py)
"""
