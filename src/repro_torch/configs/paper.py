"""The paper's own experimental configs (PixelCNN image and latent ARMs and
the discrete autoencoder), full-size and CPU-reduced variants, as the
reference's ``configs/paper.py`` gives them.

Full-size values follow Appendix A (Table 4); the reduced variants keep
the architecture family at a size the CPU tests run in seconds."""
from repro_torch.core.forecasting import PixelForecastConfig
from repro_torch.models.autoencoder import AutoencoderConfig
from repro_torch.models.pixelcnn import PixelCNNConfig

# ---- explicit likelihood modelling (paper §4.1) ---------------------------

PIXELCNN_FULL = {
    "binary_mnist": PixelCNNConfig(height=28, width=28, channels=1,
                                   categories=2, filters=60, n_res=2),
    "svhn_8bit": PixelCNNConfig(height=32, width=32, channels=3,
                                categories=256, filters=162, n_res=5),
    "cifar10_5bit": PixelCNNConfig(height=32, width=32, channels=3,
                                   categories=32, filters=162, n_res=5),
    "cifar10_8bit": PixelCNNConfig(height=32, width=32, channels=3,
                                   categories=256, filters=162, n_res=5),
}

PIXELCNN_REDUCED = {
    "binary_mnist": PixelCNNConfig(height=12, width=12, channels=1,
                                   categories=2, filters=24, n_res=2,
                                   first_kernel=5),
    "svhn_8bit": PixelCNNConfig(height=8, width=8, channels=3,
                                categories=256, filters=24, n_res=2,
                                first_kernel=5),
    "cifar10_5bit": PixelCNNConfig(height=8, width=8, channels=3,
                                   categories=32, filters=24, n_res=2,
                                   first_kernel=5),
    "cifar10_8bit": PixelCNNConfig(height=8, width=8, channels=3,
                                   categories=256, filters=24, n_res=2,
                                   first_kernel=5),
}


def forecast_cfg(pix: PixelCNNConfig, horizon: int) -> PixelForecastConfig:
    """Paper: forecasting filters == ARM filters; T = 20 (MNIST), 1 or 5."""
    return PixelForecastConfig(channels=pix.channels,
                               categories=pix.categories,
                               horizon=horizon,
                               filters=pix.filters,
                               in_filters=pix.filters)


# ---- latent-space modelling (paper §4.2) ----------------------------------

AE_FULL = AutoencoderConfig(height=32, width=32, channels=3,
                            width_filters=512, latent_channels=4,
                            latent_categories=128)
LATENT_ARM_FULL = PixelCNNConfig(height=8, width=8, channels=4,
                                 categories=128, filters=160, n_res=5)

AE_REDUCED = AutoencoderConfig(height=16, width=16, channels=3,
                               width_filters=32, latent_channels=2,
                               latent_categories=16)
LATENT_ARM_REDUCED = PixelCNNConfig(height=4, width=4, channels=2,
                                    categories=16, filters=16, n_res=2,
                                    first_kernel=3)
