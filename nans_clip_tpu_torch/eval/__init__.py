"""Eval-side helpers: model loading."""
