"""model_mfu: the model's operations per photo (the configuration's work
count at the cell's token grid) times images_per_s of the unprofiled
window, over the card's published bf16 dense peak."""


def read(run):
    if run.peaks is None or run.window.seconds <= 0:
        return None
    per_photo = run.work.flops_per_image(run.cell.config, run.net_hw)
    rate = run.window.photos / run.window.seconds
    return 100.0 * per_photo * rate / run.peaks[run.cell.config["dtype"]]
