"""DG decode CLI — the reference's decode_DG.py is a DPS clone with the
same flags and output name; preserved for script-name parity."""

from svdd.cli import decode_DPS


def main() -> None:
  parser = decode_DPS.common.make_parser('DG (DPS-clone) decoding')
  parser.add_argument('--guidance_scale', type=float, default=1e5)
  decode_DPS.run(parser.parse_args())


if __name__ == '__main__':
  main()
