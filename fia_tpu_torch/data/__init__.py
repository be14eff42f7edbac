"""Host-side data layer (numpy): datasets, the CSR interaction index,
and the synthetic generators — copies of the reference's numpy code,
byte-equal for the same seeds."""

from fia_tpu_torch._lazy import lazy_exports  # noqa: E402

# the reference's re-exports, imported on first use
__getattr__, __dir__ = lazy_exports(__name__, {
    "RatingDataset": "fia_tpu_torch.data.dataset",
    "filter_dataset": "fia_tpu_torch.data.dataset",
    "find_distances": "fia_tpu_torch.data.dataset",
    "load_movielens": "fia_tpu_torch.data.loaders",
    "load_yelp": "fia_tpu_torch.data.loaders",
    "load_dataset": "fia_tpu_torch.data.loaders",
    "synthesize_ratings": "fia_tpu_torch.data.synthetic",
    "InteractionIndex": "fia_tpu_torch.data.index",
})
