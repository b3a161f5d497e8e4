"""Rule registry for the AST lint layer.

Each rule module exposes ``NAME`` (the id used in reports, baselines and
``# lint: disable=`` comments), ``DESCRIPTION``, ``SCOPE`` (repo-relative
path prefixes the rule applies to when scanning the repo — explicit file
arguments always run every rule), and ``check(path, tree, lines)``.  A rule
whose torch name differs from the reference's carries ``REFERENCE_NAME``;
one that reads more files than its ``SCOPE`` says ``FILE_SCOPE``, and one
that scans CUDA sources ``CUDA_SCOPE`` and ``check_cuda(path, lines)``.
"""
from repro_torch.analysis.rules import (host_sync, precision, prng, retrace,
                                        tracer_branch)

ALL_RULES = (precision, host_sync, retrace, prng, tracer_branch)

__all__ = ["ALL_RULES"]
