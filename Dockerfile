# slacken container (reference: Dockerfile — Spark image + assembly jar;
# here: python + jax with its CUDA 12 wheels + this package).
#
# Build:  docker build -t slacken .
# Run:    docker run --gpus all -v /data:/data slacken classify -i /data/idx ...
FROM python:3.12-slim

# gzip for subprocess inflate; g++/make build the native parser extension
RUN apt-get update \
  && apt-get install -y --no-install-recommends gzip g++ make \
  && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/slacken

# CUDA 12 wheel set (CUDA libraries come as pip packages; the host needs
# only the NVIDIA driver); for CPU-only use, swap to plain 'jax==0.9.0'
RUN pip install --no-cache-dir "jax[cuda12]==0.9.0" \
  && pip install --no-cache-dir numpy fsspec

COPY pyproject.toml ./
COPY slacken ./slacken
COPY native ./native
COPY slacken.sh ./
RUN pip install --no-cache-dir .

ENV STPU_TMP=/data/scratch
ENV JAX_COMPILATION_CACHE_DIR=/data/jit_cache

ENTRYPOINT ["/opt/slacken/slacken.sh"]
CMD ["--help"]
