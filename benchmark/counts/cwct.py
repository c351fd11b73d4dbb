"""Operations of the cWCT on a latent, from shapes: the statistics' Gram
(2 C^2 a pixel) and the transform's product (2 C^2 a pixel); the 32x32
factorisations are left out. The regional transfer does the same work a
pixel, each pixel under its own region's transform."""


def flop(n_pixels: int, channels: int) -> float:
    return 4.0 * channels * channels * n_pixels
