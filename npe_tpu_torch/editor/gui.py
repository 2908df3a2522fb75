"""Tk frontend for the Neural Photo Editor (npe_tpu `editor/gui.py`,
reference `NPE.py:370-425`).

All editing logic lives in `EditSession`; this module is presentation only:
a 256x256 output canvas (the 64x64 image at 4x), the latent canvas (16 px a
cell), a colour-gradient bar, brush-size and colour sliders, and the
Sample / Reset / Update / Infer / Col buttons.

The coordinate and colour math is factored into widget-free helpers
(`signed_color`, `brush_box`, `paint_cell_bounds`, `gradient_swatches`,
`pool_latent_canvas`), testable without a display. `tkinter` is imported
inside `run` only, so the module imports anywhere; images reach Tk as PNG
data from `utils/png.py`, so no imaging package is needed.

Launcher: python -m npe_tpu_torch.editor.gui [--config IAN_simple]
          [--weights IAN_simple.npz] [--valid CelebAValid.npz] [--device cuda]
"""

import argparse
import base64

import numpy as np

from npe_tpu_torch.editor.engine import EditSession
from npe_tpu_torch.utils.png import encode_rgb
from npe_tpu_torch.utils.ranges import to_tanh


def hex_color(r, g, b):
    return f"#{r:02x}{g:02x}{b:02x}"


def signed_color(v):
    """Diverging blue(-255) .. white(0) .. red(+255) scale for visualizing
    signed latent cell values (the reference's red/blue ramp, `NPE.py:32-34`):
    positive values fade green+blue toward pure red, negative fade red+green
    toward pure blue."""
    v = int(np.clip(v, -255, 255))
    fade = 255 - abs(v)
    return hex_color(255, fade, fade) if v >= 0 else hex_color(fade, fade, 255)


def brush_box(x, y, brush_px, scale, w, h):
    """Map a canvas cursor position to an image-space brush square
    (`NPE.py:143-161`): side = brush_px//scale + 1 pixels, centered on the
    cursor, clamped fully inside the (w, h) image. Returns (xmin, ymin, side)
    in image pixels."""
    side = brush_px // scale + 1
    xmin = int(np.clip(x // scale - side // 2, 0, w - side))
    ymin = int(np.clip(y // scale - side // 2, 0, h - side))
    return xmin, ymin, side


def paint_cell_bounds(x, y, half, border, shape):
    """Clamped [y1:y2, x1:x2] slice bounds for a latent-canvas paint dab of
    half-width `half` centered at canvas coords (x, y), after removing the
    Tk canvas border offset (`NPE.py:283-288`)."""
    rows, cols = shape
    y1 = min(max(y - half - border, 0), rows)
    y2 = min(max(y + half - border, 0), rows)
    x1 = min(max(x - half - border, 0), cols)
    x2 = min(max(x + half - border, 0), cols)
    return y1, y2, x1, x2


def gradient_swatches(width, lo=-255, hi=255):
    """(x, color) pairs painting a `width`-pixel horizontal strip sweeping
    `signed_color` from lo to hi."""
    values = np.linspace(lo, hi, width)
    return [(x, signed_color(v)) for x, v in enumerate(values)]


def pool_latent_canvas(canvas, dim, res):
    """Per-cell mean pooling of the free-painted latent canvas
    (`NPE.py:289-291`)."""
    return canvas.reshape(dim[0], res, dim[1], res).mean(axis=(1, 3))


def run(config="IAN_simple", weights_path=None, valid_npz="CelebAValid.npz", scale=4, res=16, device="cuda",
        head_mode=None, mdblock_mode=None):
    import tkinter as tk
    from tkinter.colorchooser import askcolor

    session = EditSession(config=config, weights_path=weights_path, device=device, head_mode=head_mode,
                          mdblock_mode=mdblock_mode)
    dim = session.dim
    h, w = session.module.cfg["dims"]

    try:
        valid = np.load(valid_npz)["arr_0"]
    except (FileNotFoundError, KeyError):
        valid = None

    master = tk.Tk()
    master.title("Neural Photo Editor")

    color = tk.IntVar(value=0)
    d = tk.IntVar(value=12)
    mycol = [0, 0, 0]
    painted_rects = []
    rects = np.zeros(dim, dtype=int)
    r_canvas = np.zeros((res * dim[0], res * dim[1]), np.float32)
    bd = 2

    top = tk.Frame(master)
    top.pack(side=tk.TOP)
    output = tk.Canvas(top, name="output", width=w * scale, height=h * scale)
    pixel_rect = output.create_rectangle(0, 0, scale, scale, outline="yellow")
    output.pack()

    mid = tk.Frame(master, width=res * dim[0], height=dim[1] * 10)
    mid.pack(side=tk.TOP)
    latent_canvas = tk.Canvas(mid, name="canvas", width=res * dim[0], height=res * dim[1])
    blank = signed_color(0)
    for i in range(dim[0]):
        for j in range(dim[1]):
            rects[i, j] = latent_canvas.create_rectangle(
                j * res, i * res, (j + 1) * res, (i + 1) * res, fill=blank, outline=blank
            )
    latent_canvas.pack()

    def update_photo(data=None):
        if data is None:
            data = session.decode_current()
            data = np.uint8(np.clip(255.0 * (data + 1) / 2.0, 0, 255))
        data = np.repeat(np.repeat(np.uint8(data), scale, 1), scale, 2)
        png = base64.b64encode(encode_rgb(np.ascontiguousarray(data.transpose(1, 2, 0)))).decode()
        output.photo = tk.PhotoImage(data=png, format="png")
        output.create_image(0, 0, image=output.photo, anchor=tk.NW)
        output.tag_raise(pixel_rect)

    def update_canvas():
        nonlocal painted_rects
        for p in painted_rects:
            latent_canvas.delete(p)
        painted_rects = []
        zg = session.Z_grid
        for i in range(dim[0]):
            for j in range(dim[1]):
                cell = signed_color(255 * zg[i, j])
                latent_canvas.itemconfig(int(rects[i, j]), fill=cell, outline=cell)

    def move_mouse(event):
        xmin, ymin, side = brush_box(event.x, event.y, d.get(), scale, w, h)
        output.coords(
            pixel_rect, scale * xmin, scale * ymin, scale * (xmin + side), scale * (ymin + side)
        )
        output.tag_raise(pixel_rect)
        output.itemconfig(pixel_rect, outline=hex_color(*[int(c) for c in mycol]))

    def paint(event):
        move_mouse(event)
        x1, y1, x2, y2 = [int(c) // scale for c in output.coords(pixel_rect)]
        session.paint_stroke(x1, y1, x2, y2, mycol)
        update_canvas()
        update_photo(session.im_uint8())

    def paint_latents(event):
        dab = signed_color(color.get())
        painted_rects.append(
            event.widget.create_rectangle(
                event.x - d.get(),
                event.y - d.get(),
                event.x + d.get(),
                event.y + d.get(),
                fill=dab,
                outline=dab,
            )
        )
        y1, y2, x1, x2 = paint_cell_bounds(event.x, event.y, d.get(), bd, r_canvas.shape)
        r_canvas[y1:y2, x1:x2] = color.get() / 255.0
        session.set_latents(pool_latent_canvas(r_canvas, dim, res))
        update_canvas()
        update_photo(session.im_uint8())

    def scroll(event):
        x1, y1, x2, y2 = [int(c) // scale for c in output.coords(pixel_rect)]
        session.scroll_patch(x1, y1, x2, y2, np.sign(event.delta))
        update_canvas()
        update_photo()

    def sample():
        session.sample(np.random.randint(1 << 31))
        update_canvas()
        update_photo()

    def reset():
        session.reset()
        update_canvas()
        update_photo(session.im_uint8())

    def update_gim():
        session.update_gim()
        update_canvas()
        update_photo(session.im_uint8())

    def infer():
        if valid is None:
            print("no validation set available")
            return
        try:
            val = int(myentry.get())
        except ValueError:
            print("No input")
            val = 420
        session.infer(to_tanh(np.float32(valid[val])))
        update_canvas()
        update_photo(session.im_uint8())

    def update_brush(event):
        white = hex_color(255, 255, 255)
        brush.create_rectangle(0, 0, 25, 25, fill=white, outline=white)
        half = d.get() / 4.0
        dab = signed_color(color.get())
        brush.create_rectangle(
            int(12.5 - half), int(12.5 - half), int(12.5 + half), int(12.5 + half),
            fill=dab, outline=dab,
        )

    def get_color():
        col = askcolor(tuple(int(c) for c in mycol))
        if col[0] is not None:
            mycol[:] = col[0]

    master.bind("<MouseWheel>", scroll)
    output.bind("<Motion>", move_mouse)
    output.bind("<B1-Motion>", paint)
    latent_canvas.bind("<B1-Motion>", paint_latents)

    gradient = tk.Canvas(master, width=400, height=20)
    gradient.pack(side=tk.TOP)
    for x, swatch in gradient_swatches(400):
        gradient.create_rectangle(x, 0, x + 1, 20, fill=swatch, outline=swatch)

    color_slider = tk.Scale(
        master,
        variable=color,
        orient=tk.HORIZONTAL,
        from_=-255,
        to=255,
        length=400,
        showvalue=0,
        command=update_brush,
    )
    color_slider.pack(side=tk.TOP)

    bar = tk.Frame(master)
    for label, cmd in (("Sample", sample), ("Reset", reset), ("Update", update_gim)):
        tk.Button(bar, text=label, command=cmd).pack(side=tk.LEFT)
    brush = tk.Canvas(bar, width=25, height=25)
    size_slider = tk.Scale(
        bar,
        variable=d,
        orient=tk.HORIZONTAL,
        from_=0,
        to=64,
        length=100,
        width=25,
        showvalue=0,
        command=update_brush,
    )
    size_slider.pack(side=tk.LEFT)
    brush.pack(side=tk.LEFT)
    for label, cmd in (("Infer", infer), ("Col", get_color)):
        tk.Button(bar, text=label, command=cmd).pack(side=tk.LEFT)
    myentry = tk.Entry(bar)
    myentry.pack(side=tk.LEFT)
    bar.pack(side=tk.TOP)

    print("Running")
    if valid is not None:
        infer()
    else:
        sample()
    master.mainloop()


def main(argv=None):
    """The launcher (npe_tpu's `NPE.py`), with --device."""
    p = argparse.ArgumentParser(description="npe_tpu_torch Neural Photo Editor (Tk)")
    p.add_argument("--config", default="IAN_simple")
    p.add_argument("--weights", default=None)
    p.add_argument("--valid", default="CelebAValid.npz")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    run(config=a.config, weights_path=a.weights, valid_npz=a.valid, device=a.device)


if __name__ == "__main__":
    main()
