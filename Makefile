# svdd dev shortcuts. CPU targets force the host platform; the rest
# use the default accelerator (one JAX process per GPU).

CPU_ENV := env JAX_PLATFORMS=cpu

.PHONY: test test-fast smoke bench bench-small demo-rna demo-dna native \
        lint parity parity-fixtures comm-budget

comm-budget:      # HLO-counted per-step collective traffic per parallel
                  # strategy (virtual 8-device CPU mesh)
	PYTHONPATH=. $(CPU_ENV) python scripts/comm_budget.py

parity:           # real reference artifacts under SVDD_ARTIFACTS_DIR,
                  # data under SVDD_DATA_DIR
	python scripts/parity_harness.py --task dna
	python scripts/parity_harness.py --task rna

parity-fixtures:  # offline end-to-end smoke on generated mock torch
                  # checkpoints (RNA-size, CPU)
	$(CPU_ENV) python scripts/parity_harness.py --make_fixtures \
	    --task rna --num_steps 6 --batch_size 8 --sample_M 2 \
	    --val_batch_num 1 --artifacts_dir ./log/mock_artifacts \
	    --out_dir ./log/parity-fixtures

test:
	$(CPU_ENV) python -m pytest tests/ -q

test-fast:
	$(CPU_ENV) python -m pytest tests/ -q -x --ignore=tests/test_cli_smoke.py

smoke:            # main path at full width on one GPU
	python chip_smoke.py

bench:            # one GPU; ensure no other JAX process holds it
	python bench.py

bench-small:      # CPU self-test
	$(CPU_ENV) python bench.py --small

demo-rna:         # full trained RNA pipeline
	python scripts/demo_rna_pipeline.py

demo-dna:         # flagship DNA pipeline
	python scripts/demo_dna_pipeline.py

native:
	python -m svdd.native.build

lint:
	python -m compileall -q svdd tests scripts bench.py chip_smoke.py \
	    __graft_entry__.py
