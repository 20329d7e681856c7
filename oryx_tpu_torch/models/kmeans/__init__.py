"""k-means clustering: the Lloyd trainer on the card, evaluation metrics,
PMML codec, and the speed and serving models (host numpy)."""
