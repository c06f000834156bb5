"""Roofline table from a jax GPU trace: per-op time, TFLOP/s, GB/s, source.

    python scripts/roofline_trace.py TRACE.json.gz [steps] [peak_tflops]

Device rows are the GPU processes of the trace ('/device:GPU:N', whose
threads are the CUDA streams). peak_tflops defaults to the H100's
published dense bf16 rate, 989.
"""
import gzip
import json
import re
import sys
import collections

path = sys.argv[1]
steps = int(sys.argv[2]) if len(sys.argv) > 2 else 8
peak_tflops = float(sys.argv[3]) if len(sys.argv) > 3 else 989.0

data = json.load(gzip.open(path, 'rt'))
pid_names = {}
for ev in data['traceEvents']:
  if ev.get('ph') == 'M' and ev.get('name') == 'process_name':
    pid_names[ev['pid']] = ev['args'].get('name', '')
device_pids = {p for p, n in pid_names.items() if '/device:GPU' in n}

rows = collections.defaultdict(
    lambda: dict(ms=0.0, n=0, flops=0, bytes=0, src='', shape=''))
for ev in data['traceEvents']:
  if ev.get('ph') != 'X' or ev.get('pid') not in device_pids:
    continue
  name = ev.get('name', '')
  args = ev.get('args', {})
  cat = args.get('hlo_category', '')
  if cat in ('while', '') and 'jit_' in name:
    continue
  if cat == 'while':
    continue
  r = rows[name]
  r['ms'] += ev.get('dur', 0) / 1e3
  r['n'] += 1
  r['flops'] = int(args.get('model_flops', 0) or 0)
  r['bytes'] = int(args.get('raw_bytes_accessed', 0) or 0)
  r['src'] = args.get('source', '')
  ln = args.get('long_name', '')
  m = re.match(r'%\S+ = (\S+?)\{', ln)
  r['shape'] = m.group(1) if m else ''
  r['cat'] = cat

total = sum(r['ms'] for r in rows.values())
# model_flops is per-occurrence; n counts occurrences across all steps
tflop = sum(r['flops'] * r['n'] for r in rows.values()) / 1e12
print(f'leaf device time: {total:.1f} ms total, {total/steps:.1f} ms/step')
print(f'XLA-counted: {tflop/steps:.2f} TFLOP/step -> speed-of-light '
      f'{tflop/steps/peak_tflops*1e3:.2f} ms/step at {peak_tflops:.0f} '
      f'TF/s ({tflop/total*1e3:.0f} TF/s achieved overall)')
print(f'{"ms/st":>7} {"%":>5} {"TF/s":>6} {"GB/s":>6}  shape | src | name')
acc = 0.0
for name, r in sorted(rows.items(), key=lambda kv: -kv[1]['ms']):
  ms = r['ms'] / steps
  if ms < 0.05:
    continue
  acc += ms
  sec_per_call = r['ms'] / 1e3 / r['n']
  tf = r['flops'] / sec_per_call / 1e12 if r['flops'] else 0
  gb = r['bytes'] / sec_per_call / 1e9 if r['bytes'] else 0
  src = r['src'].split('svdd/', 1)[-1]
  print(f'{ms:7.2f} {100*ms*steps/total:5.1f} {tf:6.1f} {gb:6.0f}  '
        f'{r["shape"][:28]:28} | {src[:40]:40} | {name[:40]}')
print(f'(rows >=0.05 ms/step cover {acc:.1f} ms/step)')
