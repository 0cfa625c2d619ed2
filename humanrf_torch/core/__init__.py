"""Dataset model and IO: image codec, cameras, AABBs, the ActorsHQ layout, the synthetic scene."""
